"""The port's dry-run (``launch/specs.py``, ``launch/dryrun.py``) against
the JAX package's, on the CPU.

The reference's per-rank bytes are its own arithmetic (the 12 lines of
``repro.launch.dryrun.sharded_param_bytes``, restated here) over its specs
on a ``jax.sharding.AbstractMesh``, which needs no devices.
``repro.launch.dryrun`` itself is never imported: it sets ``XLA_FLAGS``
when imported, which would give every JAX test of an xdist worker 512 CPU
devices.

Dtype mapping of the inputs: the reference's int32 tokens and labels are
the port's int64 (its token dtype); ``inputs_embeds`` and ``frames`` are
bfloat16 in both.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.parallel import sharding as jshd
from repro.roofline import analysis as janalysis
from repro_torch.configs import registry
from repro_torch.configs.shapes import LONG_OK, SHAPES
from repro_torch.kernels import build
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.rbf import ops as rbf_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import dryrun, specs, train
from repro_torch.optim.adam import Adam

DTYPES = {jnp.int32: torch.int64, jnp.bfloat16: torch.bfloat16}
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_input_specs_are_the_references(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    for name in SHAPES:
        got, want = specs.input_specs(cfg, name), jspecs.input_specs(jcfg,
                                                                     name)
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert t.dtype == DTYPES[want[k].dtype.type]


def _ref_bytes(tree, spec_tree, mesh) -> float:
    """The reference's ``sharded_param_bytes``."""
    total = 0.0
    for sds, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, P))):
        n = 1
        for axes in spec:
            if axes is None:
                continue
            for a in (axes,) if isinstance(axes, str) else axes:
                n *= mesh.shape[a]
        total += sds.size * sds.dtype.itemsize / n
    return total


def _ref_decode_bytes(jcfg, shape, mesh) -> float:
    """The reference's decode cell: float32 parameters, the serve state of
    T + 512 positions with the cross K/V precomputed."""
    B, T = shape.global_batch, shape.seq_len

    def mk():
        p = jtf.init_model(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        st = jtf.init_serve(jcfg, B, T + 512, enc_kv=None)
        if jcfg.enc_dec:
            enc = jnp.zeros((B, jcfg.enc_seq, jcfg.d_model), jnp.bfloat16)
            st = st._replace(cross_kv=jtf.precompute_cross_kv(p, enc, jcfg))
        return p, st

    params, state = jax.eval_shape(mk)
    return (_ref_bytes(params, jshd.param_specs(params, mesh), mesh)
            + _ref_bytes(state, jserve.serve_state_specs(jcfg, mesh,
                                                         batch=B), mesh))


def _attn_caches(cfg) -> int:
    return sum(d.kind == "attn" for d in cfg.plan())


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_per_rank_bytes_are_the_references(arch):
    """Train: 3x the parameters (with Adam's moments). Decode: parameters
    plus the serve state; the reference also holds each attention cache's
    filled length as a replicated int32 (4 bytes), which the port keeps as
    a host int."""
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    jparams = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                    jcfg))
    for name, (sizes, axes) in MESHES.items():
        mesh = AbstractMesh(sizes, axes)
        want = 3 * _ref_bytes(jparams, jshd.param_specs(jparams, mesh), mesh)
        _, _, got = dryrun.train_state(cfg, dryrun.MESHES[name])
        assert got == want, (name, got, want)
        for sname in ("decode_32k", "long_500k"):
            if sname == "long_500k" and arch not in LONG_OK:
                continue
            shape = SHAPES[sname]
            got = dryrun.serve_state(
                cfg, dryrun.MESHES[name], batch=shape.global_batch,
                max_len=shape.seq_len + 512)[-1]
            want = _ref_decode_bytes(jcfg, shape, mesh)
            assert got == want - 4 * _attn_caches(cfg), (name, sname)


def _flops(cfg, device) -> int:
    """FLOP of one smoke train step (remat on) on ``device``."""
    opt = Adam(lr=1e-3)
    state = train.init_state(cfg, opt, generator=torch.Generator(
        ).manual_seed(0), device=device)
    step, _ = train.make_train_step(cfg, None, opt, remat=True,
                                    compute_dtype=torch.float32)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in specs.train_input_specs(
                 cfg, SHAPES["train_4k"].__class__("s", 32, 2,
                                                   "train")).items()}
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-130m"])
def test_meta_runs_the_real_paths_ops(arch):
    cfg = registry.smoke_config(arch)
    got, want = _flops(cfg, "meta"), _flops(cfg, "cpu")
    assert got == want > 0


REF_KEYS = set(janalysis.Roofline.__dataclass_fields__) | {
    "memory_analysis", "lower_s", "compile_s", "cost_analysis"}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_a_cell_gives_an_ok_record(shape):
    rec = dryrun.run_cell("qwen3-1.7b", shape, {"data": 2, "model": 2},
                          overrides={"n_layers": 2})
    assert REF_KEYS <= set(rec)
    assert rec["mesh"] == "data2_model2" and rec["chips"] == 4
    assert rec["hlo_flops"] == rec["hlo_flops_raw"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["bytes_per_device"] > 0 and rec["t_compute"] > 0
    assert rec["host_values"] == []
    coll = rec["collective"]
    assert coll["total"] == 4 * coll["rank_bytes"]
    # qwen3 at 2 layers is under the size policy's 4 GB: pure data
    # parallelism, so the train step only sums (gradients, the loss); a
    # decode step splits the vocabulary over "model" and gathers its rows
    kinds = set(coll["collectives"])
    assert kinds == ({"sum"} if shape == "train_4k" else {"_cat"})
    assert json.loads(json.dumps(rec)) == rec


def test_cli_writes_a_skip_outside_long_ok(tmp_path):
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-1.7b_long_500k_single.json")
                     .read_text())
    assert rec["status"] == "skip"


def test_meta_inputs_take_the_plain_version_and_mixed_inputs_raise():
    meta = lambda *s: torch.empty(s, device="meta")
    assert build.on_cpu(meta(2, 3), meta(4, 3))
    assert build.on_cpu(torch.zeros(2), torch.zeros(3))
    with pytest.raises(ValueError, match="meta"):
        build.on_cpu(meta(2, 3), torch.zeros(4, 3))
    before = (rbf_ops.rbf_launches, attn_ops.flash_launches,
              ssd_ops.ssd_launches)
    assert rbf_ops.rbf_covariance(meta(5, 3), meta(2, 7, 3), 1.3).shape == \
        (2, 5, 7)
    q = meta(1, 2, 8, 16)
    assert attn_ops.attention(q, meta(1, 1, 8, 16),
                              meta(1, 1, 8, 16)).device.type == "meta"
    y, s, cum = ssd_ops.intra_chunk(meta(2, 8, 3, 4), meta(2, 3, 8),
                                    meta(2, 8, 5), meta(2, 8, 5))
    assert (y.shape, s.shape, cum.shape) == ((2, 8, 3, 4), (2, 3, 4, 5),
                                             (2, 3, 8))
    assert (rbf_ops.rbf_launches, attn_ops.flash_launches,
            ssd_ops.ssd_launches) == before
    with pytest.raises(ValueError, match="meta"):
        rbf_ops.rbf_covariance(meta(5, 3), torch.zeros(7, 3), 1.3)


def test_recording_axes_count_each_collective():
    axes = dryrun.RecordingAxes({"data": 2, "model": 4})
    t = torch.zeros(3, 5)
    assert axes.gather(t, ("data", "model")).shape == (6, 20)
    assert torch.equal(axes.sum(torch.ones(2), ("data", "model")),
                       torch.full((2,), 8.0))
    axes.max(torch.ones(()))
    rep = axes.report(8)
    assert rep["collectives"] == {
        "_cat": {"calls": 2, "bytes": 4 * (6 * 5 + 6 * 20)},
        "sum": {"calls": 1, "bytes": 8}, "max": {"calls": 1, "bytes": 4}}
    assert rep["by_axis"]["model"]["calls"] == 3
    assert rep["total"] == 8 * rep["rank_bytes"]
