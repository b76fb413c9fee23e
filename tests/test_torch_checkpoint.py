"""The port's checkpoints (``checkpoint/io.py``, ``checkpoint/manager.py``),
its token loader (``data/loader.py``) and its sharding rules
(``parallel/sharding.py``) on the CPU against the JAX package.

Checkpoint files are the reference's format byte for byte: a tree saved by
either package loads bit for bit in the other, and a JAX ``TrainState``
after two steps resumes in the port, both packages' next two steps
agreeing. The header's msgpack is the port's own codec, held against the
``msgpack`` package here. Sharding specs equal the reference's leaf for
leaf on stub meshes (the reference reads only a mesh's ``shape``).
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.checkpoint import manager as jmanager
from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.optim.adam import Adam as JAdam
from repro.parallel import sharding as jshd
from repro_torch import convert
from repro_torch.checkpoint import io
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.loader import TokenLoader
from repro_torch.launch import train
from repro_torch.optim.adam import Adam, tree_leaves
from repro_torch.parallel import sharding

MISMATCH_ABS, MISMATCH_FRAC = 2e-5, 0.01   # tests/test_launch.py:114-119


def _no_x64(fn):
    def run(*args, **kw):
        with jax.enable_x64(False):
            return fn(*args, **kw)
    return run


# --- the header codec ----------------------------------------------------------

def _headers():
    yield []
    yield [{"key": "k:a", "dtype": "<f4", "shape": [], "nbytes": 4}]
    # strings across fixstr / str8 / str16, ints across every width,
    # arrays and maps past their fix forms
    for n in (0, 31, 32, 255, 256, 70000):
        yield {"key": "x" * n, "shape": [0, 127, 128, 255, 256, 65535,
                                          65536, 2 ** 32 - 1, 2 ** 32,
                                          2 ** 63]}
    yield [list(range(n)) for n in (15, 16, 70000)]
    yield {f"k{i}": i for i in range(17)}
    yield [{"key": f"a:params/k:layers/i:{i}/k:attn/k:wq", "dtype": "<f4",
            "shape": [64, 128], "nbytes": 32768} for i in range(40)]


@pytest.mark.parametrize("obj", list(_headers()))
def test_header_codec_is_msgpack(obj):
    assert io.packb(obj) == msgpack.packb(obj)
    assert io.unpackb(msgpack.packb(obj)) == obj


def test_header_codec_refuses_what_the_format_has_not():
    for bad in (-1, 1.5, None, True, b"x"):
        with pytest.raises((TypeError, ValueError)):
            io.packb([bad])
    with pytest.raises(ValueError, match="type 0xc0"):
        io.unpackb(msgpack.packb(None))


# --- files both ways -----------------------------------------------------------

class Pair(NamedTuple):
    w: object
    n: object


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": [rng.normal(size=(3, 4)).astype(np.float32),
                  np.int32(7) * np.ones((), np.int32)],
            "a": Pair(rng.normal(size=(5,)).astype(np.float32),
                      rng.integers(0, 9, (2, 2)).astype(np.int64)),
            "z": None,
            "h": rng.normal(size=(4, 8)).astype(ml_dtypes.bfloat16),
            "c": {"y": rng.normal(size=(2, 3, 4)),
                  "x": np.array([True, False])}}


def _as_torch(tree):
    def one(_, a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return io.map_leaves(one, tree)


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _bits(t) -> np.ndarray:
    a = io.to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.reshape(-1).view(np.uint8)


def test_a_tree_saved_by_either_package_loads_bitwise_in_the_other(tmp_path):
    tree = _tree_np()
    jtree, ttree = _as_jax(tree), _as_torch(tree)
    with jax.enable_x64(True):
        jio.save(tmp_path / "from_jax", jtree)
    io.save(tmp_path / "from_port", ttree)
    # the same bytes, header and buffers
    assert (tmp_path / "from_jax").read_bytes() == \
        (tmp_path / "from_port").read_bytes()
    got = io.load(tmp_path / "from_jax", ttree)
    for a, b in zip(io.flatten(got), io.flatten(ttree)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert np.array_equal(_bits(a[1]), _bits(b[1])), a[0]
    # the reference's loader reads no bfloat16 leaf (numpy has no cast from
    # its "<V2" to bfloat16, its own files included): that leaf goes one
    # way only
    del jtree["h"]
    with jax.enable_x64(True):
        back = jio.load(tmp_path / "from_port", jtree)
    for (k, a), (_, b) in zip(io.flatten(back), io.flatten(jtree)):
        assert np.array_equal(_bits(a), _bits(b)), k
    assert got["z"] is None and isinstance(got["a"], Pair)
    assert list(io.read(tmp_path / "from_jax")) == \
        [k for k, _ in io.flatten(ttree)]


def test_load_refuses_a_missing_or_reshaped_leaf(tmp_path):
    io.save(tmp_path / "t", {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="k:b"):
        io.load(tmp_path / "t", {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        io.load(tmp_path / "t", {"a": torch.zeros(4)})
    assert not list(tmp_path.glob("*.tmp"))      # replaced atomically


def test_manager_rotates_and_saves_asynchronously(tmp_path):
    tree = _as_torch(_tree_np(1))
    m = CheckpointManager(tmp_path, keep=2)
    for step in range(4):
        m.save(step, tree, sync=False)
        saved = tree["b"][0].clone()
        # the snapshot was taken on this thread: changing the tree now
        # does not reach the file being written
        tree["b"][0].add_(1.0)
    m.wait()
    assert m.steps() == [2, 3] and m.latest_step() == 3
    step, got = m.restore_latest(_as_torch(_tree_np(1)))
    assert step == 3
    assert torch.equal(got["b"][0], saved)
    # the reference's manager reads the port's files, and the other way
    jm = jmanager.CheckpointManager(tmp_path, keep=2)
    assert jm.steps() == [2, 3]
    with jax.enable_x64(True):
        jm.save(5, _as_jax(_tree_np(2)))
    assert m.steps() == [3, 5]
    got = m.restore(5, _as_torch(_tree_np(1)))
    assert torch.equal(got["b"][0], _as_torch(_tree_np(2))["b"][0])
    assert CheckpointManager(tmp_path / "empty").restore_latest(tree) == \
        (None, None)


# --- resume a JAX TrainState in the port ----------------------------------------

def _f32_steps(mp):
    """The reference's train step in float32: it takes no compute dtype, so
    its loss and encoder are given one at run time."""
    for name in ("lm_loss", "encode"):
        orig = getattr(jtf, name)
        mp.setattr(jtf, name, lambda *a, _o=orig, **k:
                   _o(*a, **{"compute_dtype": jnp.float32, **k}))


def test_a_jax_train_state_resumes_in_the_port(tmp_path, monkeypatch):
    """Two steps in JAX, saved by the reference's checkpoint io, read by the
    port (``io.read`` -> ``io.nest`` -> ``convert.train_state_from_arrays``);
    then two more steps in each package agree (float32 compute), and the
    port's state saved and restored is bitwise its own."""
    _f32_steps(monkeypatch)
    jcfg = jreg.smoke_config("mamba2-130m")
    cfg = registry.smoke_config("mamba2-130m")
    jopt, opt = JAdam(lr=1e-3), Adam(lr=1e-3)
    jstep = _no_x64(jax.jit(jtrain.make_train_step(jcfg, None, jopt,
                                                   compress=True)[0]))
    step, _ = train.make_train_step(cfg, None, opt, compress=True,
                                    compute_dtype=torch.float32)
    jstate = _no_x64(jtrain.init_state)(jax.random.PRNGKey(0), jcfg, jopt,
                                        compress=True)
    loader = TokenLoader(cfg, batch=2, seq=16, seed=3, device="cpu")
    batches = [next(loader) for _ in range(4)]
    jb = [{k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()}
          for b in batches]
    for b in jb[:2]:
        jstate, _ = jstep(jstate, b)
    jio.save(tmp_path / "jax_state", jstate)
    state = convert.train_state_from_arrays(
        io.nest(io.read(tmp_path / "jax_state")), cfg, device="cpu")
    assert int(state.step) == 2 and int(state.opt.step) == 2
    assert state.ef is not None
    for jb_, tb in zip(jb[2:], batches[2:]):
        jstate, jm = jstep(jstate, jb_)
        state, m = step(state, tb)
        assert abs(float(m.loss) - float(jm.loss)) <= 1e-5 * float(jm.loss)
    want = convert.train_state_from_arrays(jax.tree.map(np.asarray, jstate),
                                           cfg, device="cpu")
    for a, b in zip(tree_leaves(state.params), tree_leaves(want.params)):
        frac = float(((a - b).abs() > MISMATCH_ABS).float().mean())
        assert frac < MISMATCH_FRAC
    io.save(tmp_path / "port_state", state)
    back = io.load(tmp_path / "port_state", state)
    for (k, a), (_, b) in zip(io.flatten(back), io.flatten(state)):
        assert torch.equal(a, b), k


# --- the token loader ------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-1.7b", "whisper-medium",
                                  "qwen2-vl-72b"])
def test_token_loader_resumes_exactly(name):
    cfg = registry.smoke_config(name)
    a = TokenLoader(cfg, batch=3, seq=12, seed=5, device="cpu")
    first = [next(a) for _ in range(4)]
    b = TokenLoader(cfg, batch=3, seq=12, seed=5, device="cpu")
    next(b)
    saved = b.save_state()
    c = TokenLoader(cfg, batch=3, seq=12, seed=0, device="cpu")
    c.restore_state(saved)
    for want in first[1:]:
        got = next(c)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    batch = first[0]
    assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])
    assert batch["tokens"].shape == (3, 12)
    assert int(batch["tokens"].max()) < cfg.vocab
    if cfg.enc_dec:
        assert batch["frames"].shape == (3, cfg.enc_seq, cfg.d_model)
        assert batch["frames"].dtype == torch.bfloat16
    if cfg.family == "vlm":
        assert batch["inputs_embeds"].shape == (3, 12, cfg.d_model)
        assert batch["inputs_embeds"].dtype == torch.bfloat16
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        TokenLoader(cfg, {"data": 2}, batch=3, seq=4, device="cpu")


# --- sharding rules ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StubMesh:
    """What the reference's rules read of a mesh: its axis sizes."""
    shape: dict

    def __hash__(self):
        return hash(tuple(self.shape.items()))


MESHES = [{"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 2}]


def _meta_port_tree(jtree, cfg):
    """The reference's (abstract) parameter tree as the port's flat-layer
    tree of meta tensors: stacked leaf [pos][i] -> layer i * period + pos;
    the remainder layers follow; the encoder's stack -> a list."""
    meta = lambda s, idx=False: None if s is None else torch.empty(
        s.shape[1:] if idx else s.shape, dtype=torch.float32, device="meta")

    def walk(node, idx=False):
        if isinstance(node, dict):
            return {k: walk(v, idx) for k, v in node.items()}
        return meta(node, idx)

    period, n_full = cfg.period, cfg.n_layers // cfg.period
    stack, rest = jtree.get("stack", ()), jtree.get("rest", ())
    out = {"embed": walk(jtree["embed"]),
           "layers": [walk(stack[pos], True) for _ in range(n_full)
                      for pos in range(period)] + [walk(r) for r in rest],
           "final_norm": walk(jtree["final_norm"])}
    if cfg.enc_dec:
        out["encoder"] = [walk(jtree["encoder"], True)
                          for _ in range(cfg.enc_layers)]
    return out


def _port_view(jspecs, cfg):
    """The reference's spec tree in the port's layout, the stacked leaves'
    leading (scan) entry dropped."""
    inner = lambda node: {k: inner(v) for k, v in node.items()} \
        if isinstance(node, dict) else (None if node is None
                                        else tuple(node)[1:])
    plain = lambda node: {k: plain(v) for k, v in node.items()} \
        if isinstance(node, dict) else (None if node is None
                                        else tuple(node))
    period, n_full = cfg.period, cfg.n_layers // cfg.period
    stack, rest = jspecs.get("stack", ()), jspecs.get("rest", ())
    out = {"embed": plain(jspecs["embed"]),
           "layers": [inner(stack[pos]) for _ in range(n_full)
                      for pos in range(period)] + [plain(r) for r in rest],
           "final_norm": plain(jspecs["final_norm"])}
    if cfg.enc_dec:
        out["encoder"] = [inner(jspecs["encoder"])] * cfg.enc_layers
    return out


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m",
                                  "qwen3-moe-30b-a3b", "whisper-medium",
                                  "jamba-1.5-large-398b", "olmo-1b"])
@pytest.mark.parametrize("mesh", MESHES, ids=["data4-model2",
                                              "pod2-data2-model2"])
def test_param_specs_equal_the_references(name, mesh):
    """At full width (abstract shapes, nothing allocated): the auto policy
    (TP above 4 GB of parameters) and both forced policies."""
    cfg, jcfg = registry.get_config(name), jreg.get_config(name)
    if name == "jamba-1.5-large-398b":      # one period plus a remainder
        cfg = cfg.scaled(n_layers=cfg.period + 1)
        jcfg = jcfg.scaled(n_layers=jcfg.period + 1)
    jtree = jax.eval_shape(lambda k: jtf.init_model(k, jcfg),
                           jax.random.PRNGKey(0))
    ptree = _meta_port_tree(jtree, cfg)
    stub = StubMesh(mesh)
    assert sharding.use_tp_policy(ptree) == jshd.use_tp_policy(jtree)
    for use_tp in (None, True, False):
        want = _port_view(jshd.param_specs(jtree, stub, use_tp=use_tp), cfg)
        got = sharding.param_specs(ptree, mesh, use_tp=use_tp)
        assert got == want, use_tp


@pytest.mark.parametrize("mesh", MESHES, ids=["data4-model2",
                                              "pod2-data2-model2"])
def test_batch_cache_logits_and_state_specs_equal_the_references(mesh):
    stub = StubMesh(mesh)
    assert sharding.dp_axes(mesh) == jshd.dp_axes(stub)
    for batch in (None, 1, 2, 3, 4, 8, 6):
        for use_tp in (True, False):
            assert sharding.batch_spec(mesh, use_tp, batch) == \
                tuple(jshd.batch_spec(stub, use_tp, batch))
        for vocab in (None, 50280, 151936, 151937):
            if batch is not None:
                assert sharding.logits_spec(mesh, batch=batch, vocab=vocab) \
                    == tuple(jshd.logits_spec(stub, batch=batch, vocab=vocab))
        if batch is None:
            continue
        for n_kv in (1, 2, 4, 8):
            for stacked in (True, False):
                assert sharding.cache_spec(
                    mesh, batch=batch, n_kv=n_kv, seq=4096,
                    stacked=stacked) == tuple(jshd.cache_spec(
                        stub, batch=batch, n_kv=n_kv, seq=4096,
                        stacked=stacked))
                assert sharding.ssm_state_spec(
                    mesh, batch=batch, n_heads=n_kv * 3,
                    stacked=stacked) == tuple(jshd.ssm_state_spec(
                        stub, batch=batch, n_heads=n_kv * 3,
                        stacked=stacked))
    assert sharding.axis_sizes(stub) == mesh
