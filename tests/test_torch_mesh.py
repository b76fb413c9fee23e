"""The LM's steps over a ``DeviceMesh`` (``launch.train``'s ``on_mesh``,
``launch.serve.make_serve_step``, ``TokenLoader(mesh=)``,
``parallel.sharding``'s placement) on four gloo ranks on the CPU, mesh
(2, 2) ("data", "model"), against the port's one-process step on the same
state and batch, in float64.

The proof is a chain of two links: here the step over ranks equals the
one-process step within 1e-10; ``test_torch_train.py`` and
``test_torch_lm.py`` hold the one-process step against the JAX package.
The reference's own mesh test (``tests/test_launch.py``) cannot be the
yardstick: it fails under jax 0.9.

One spawn for the whole file: four processes (``torch.multiprocessing``,
spawn start method, one thread each) join a process group through a
``file://`` rendezvous in a temporary directory. Each forces tensor
parallelism on (at smoke size the size policy would replicate every
parameter) by setting ``sharding.PURE_DP_THRESHOLD_BYTES`` to 0 but in
the "pure-dp" cases, runs
every case, all-gathers its results (``gather_shards``) and returns them
as numpy arrays. The children import torch and the port only; this module
imports JAX inside the one test that runs the reference.

A child's exception fails every case with its traceback; a child that does
not answer within JOIN_S fails them too.
"""
import itertools
import queue
import time
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
MESH = ((2, 2), ("data", "model"))
JOIN_S = 180.0
# Both sides compute in float64 throughout (``layers.wide``); they differ
# in summation order only: rows summed over ranks against one GEMM, a mean
# of means against one mean, an attention combined from two halves.
TOL = 1e-10
F64 = torch.float64
T = 16
TRAIN_STEPS = 2

# name -> (model, config overrides, make_train_step kwargs, Adam kwargs,
# global batch)
TRAIN = {
    "qwen3-mb2-compress-clip": ("qwen3-1.7b", {},
                                dict(microbatches=2, compress=True),
                                dict(clip_norm=0.5), 8),
    "mamba2-mb2": ("mamba2-130m", {}, dict(microbatches=2), {}, 8),
    "mixtral-gather-groups1": ("mixtral-8x22b", {"moe_dispatch": "gather"},
                               dict(moe_groups=1), {}, 4),
    "mixtral-gather-groups2": ("mixtral-8x22b", {"moe_dispatch": "gather"},
                               dict(moe_groups=2), {}, 4),
    "mixtral-gather-groups1-mb2": ("mixtral-8x22b",
                                   {"moe_dispatch": "gather"},
                                   dict(moe_groups=1, microbatches=2), {}, 8),
    "whisper-frames": ("whisper-medium", {}, {}, {}, 4),
    "qwen2-vl-embeds": ("qwen2-vl-72b", {}, {}, {}, 4),
    # the size policy's choice at this size: every parameter replicated
    "mamba2-pure-dp": ("mamba2-130m", {}, {}, {}, 8),
}
# name -> (model, batch, max_len, decode steps)
SERVE = {
    "qwen3-B8": ("qwen3-1.7b", 8, 32, 4),
    "qwen3-B1-seq": ("qwen3-1.7b", 1, 32, 20),
    "mamba2-B8": ("mamba2-130m", 8, 32, 4),
    "whisper-B1-seq": ("whisper-medium", 1, 32, 18),
    "mixtral-B4": ("mixtral-8x22b", 4, 32, 4),
    "mamba2-B8-pure-dp": ("mamba2-130m", 8, 32, 4),
}


def _cfg(name, overrides=None):
    from repro_torch.configs import registry
    cfg = registry.smoke_config(name).scaled(**(overrides or {}))
    if cfg.ssm_state:
        cfg = cfg.scaled(ssm_chunk=8)
    return cfg


def _f64(tree):
    from repro_torch.optim.adam import tree_map
    return tree_map(lambda t: t.to(F64) if t.is_floating_point() else t,
                    tree)


def _np(t):
    """numpy of ``t`` (a tensor, or a cache's host int); bfloat16 as its
    bits (int16)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _train_inputs(case):
    from repro_torch.launch import train
    from repro_torch.optim.adam import Adam
    name, over, kw, adam, B = TRAIN[case]
    cfg = _cfg(name, over)
    opt = Adam(lr=1e-3, **adam)
    state = _f64(train.init_state(
        cfg, opt, generator=torch.Generator().manual_seed(0), device="cpu",
        compress=kw.get("compress", False)))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(TRAIN_STEPS):
        toks = torch.tensor(rng.integers(0, cfg.vocab, (B, T + 1)))
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.enc_dec:
            b["frames"] = torch.tensor(rng.normal(
                size=(B, cfg.enc_seq, cfg.d_model)))
        if cfg.family == "vlm":
            b["inputs_embeds"] = torch.tensor(rng.normal(
                size=(B, T, cfg.d_model)))
        batches.append(b)
    return cfg, opt, kw, state, batches


def _train_result(state, metrics) -> dict:
    from repro_torch.optim.adam import tree_leaves
    out = {f"leaf{i}": _np(t) for i, t in enumerate(tree_leaves(state))}
    for i, m in enumerate(metrics):
        for f in type(m)._fields:
            out[f"step{i}.{f}"] = _np(getattr(m, f))
    return out


def _serve_inputs(case):
    from repro_torch.models import transformer as tf
    name, B, max_len, steps = SERVE[case]
    cfg = _cfg(name)
    params = _f64(tf.init_model(cfg, generator=torch.Generator()
                                .manual_seed(1), device="cpu"))
    state = tf.init_serve(cfg, B, max_len, device="cpu", cache_dtype=F64)
    rng = np.random.default_rng(2)
    if cfg.enc_dec:
        frames = torch.tensor(rng.normal(size=(B, cfg.enc_seq,
                                               cfg.d_model)))
        enc = tf.encode(params, frames, cfg, compute_dtype=F64)
        state = state._replace(cross_kv=tf.precompute_cross_kv(
            params, enc, cfg, compute_dtype=F64))
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, steps)))
    return cfg, params, state, toks


def _serve_result(logits, state) -> dict:
    from repro_torch.optim.adam import tree_leaves
    out = {f"logits{i}": _np(lg) for i, lg in enumerate(logits)}
    out.update({f"cache{i}": _np(t)
                for i, t in enumerate(tree_leaves(state.caches))})
    return out


# --- the children ------------------------------------------------------------

def _mesh_train(mesh, case) -> dict:
    from repro_torch.launch import train
    from repro_torch.parallel import sharding as shd
    cfg, opt, kw, state, batches = _train_inputs(case)
    specs = train.state_specs(state, mesh)
    _, on_mesh = train.make_train_step(cfg, mesh, opt, compute_dtype=F64,
                                       **kw)
    step = on_mesh(state)
    local = shd.local_shards(state, specs, mesh)
    rows = {k: (shd.batch_spec(mesh)[0],) for k in batches[0]}
    metrics = []
    for b in batches:
        local, m = step(local, shd.local_shards(b, rows, mesh))
        metrics.append(m)
    return _train_result(shd.gather_shards(local, specs, mesh), metrics)


def _mesh_serve(mesh, case) -> dict:
    from repro_torch.launch import serve
    from repro_torch.parallel import sharding as shd
    cfg, params, state, toks = _serve_inputs(case)
    B = toks.shape[0]
    specs = serve.serve_state_specs(cfg, mesh, batch=B)
    _, built = serve.make_serve_step(cfg, mesh, batch=B, compute_dtype=F64)
    sharded = built(params)
    local_p = shd.local_shards(params, shd.param_specs(params, mesh), mesh)
    local_s = shd.local_shards(state, specs, mesh)
    lspec = shd.logits_spec(mesh, batch=B, vocab=cfg.vocab_padded)
    tspec = (lspec[0], None)
    logits = []
    for t in range(toks.shape[1]):
        tok = shd.local_shards(toks[:, t:t + 1], tspec, mesh)
        lg, local_s = sharded(local_p, tok, local_s)
        logits.append(shd.gather_shards(lg, lspec, mesh))
    return _serve_result(logits, shd.gather_shards(local_s, specs, mesh))


def _mesh_loader(mesh) -> dict:
    from repro_torch.data.loader import TokenLoader
    cfg = _cfg("whisper-medium")
    ld = TokenLoader(cfg, mesh, batch=8, seq=T, device="cpu", seed=5)
    out = {}
    for i in range(2):
        for k, v in next(ld).items():
            out[f"b{i}.{k}"] = _np(v)
    again = TokenLoader(cfg, mesh, batch=8, seq=T, device="cpu", seed=0)
    again.restore_state(ld.save_state())
    for k, v in next(again).items():
        out[f"b2.{k}"] = _np(v)
    return out


def _child(rank, rdv, q):
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        from repro_torch.launch import mesh as tmesh
        from repro_torch.parallel import sharding as shd
        mesh = tmesh.make_mesh(*MESH, rank=rank, world_size=WORLD,
                               init_method=f"file://{rdv}", backend="gloo",
                               device="cpu", timeout_s=JOIN_S)
        out = {"coords": np.array(mesh.get_coordinate())}
        out["loader"] = _mesh_loader(mesh)
        for kind, cases, run in (("train", TRAIN, _mesh_train),
                                 ("serve", SERVE, _mesh_serve)):
            for case in cases:
                shd.PURE_DP_THRESHOLD_BYTES = (4e9 if case.endswith(
                    "pure-dp") else 0)
                out[f"{kind}.{case}"] = run(mesh, case)
        q.put((rank, out, None))
    except Exception:
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """rank -> results of the four children."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, str(tmp / "rdv"), q),
                         daemon=True) for r in range(WORLD)]
    for pr in procs:
        pr.start()
    got, errors = {}, []
    deadline = time.monotonic() + JOIN_S
    try:
        while len(got) + len(errors) < WORLD:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, out, tb = q.get(timeout=min(left, 5.0))
            except queue.Empty:
                if not any(pr.is_alive() for pr in procs) and q.empty():
                    break
                continue
            if tb is not None:
                errors.append(f"rank {rank}:\n{tb}")
            else:
                got[rank] = out
    finally:
        for pr in procs:
            pr.join(timeout=max(0.0, deadline - time.monotonic()))
            if pr.is_alive():
                pr.kill()
                pr.join()
    if errors:
        pytest.fail("a rank raised:\n" + "\n".join(errors))
    if len(got) < WORLD:
        pytest.fail(f"only ranks {sorted(got)} answered within {JOIN_S} s; "
                    f"exit codes {[pr.exitcode for pr in procs]}")
    return got


def _one_process_train(case) -> dict:
    from repro_torch.launch import train
    cfg, opt, kw, state, batches = _train_inputs(case)
    step, _ = train.make_train_step(cfg, None, opt, compute_dtype=F64, **kw)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append(m)
    return _train_result(state, metrics)


def _one_process_serve(case) -> dict:
    from repro_torch.models import transformer as tf
    cfg, params, state, toks = _serve_inputs(case)
    logits = []
    for t in range(toks.shape[1]):
        lg, state = tf.decode_step(params, toks[:, t:t + 1], state, cfg,
                                   compute_dtype=F64)
        logits.append(lg)
    return _serve_result(logits, state)


def _close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        assert np.abs(g - w).max(initial=0.0) <= TOL, \
            (k, float(np.abs(g - w).max()))


def _same_on_every_rank(ranks, key) -> dict:
    first = ranks[0][key]
    for r in range(1, WORLD):
        for k, v in first.items():
            np.testing.assert_array_equal(ranks[r][key][k], v, err_msg=k)
    return first


@pytest.mark.parametrize("case", list(TRAIN))
def test_train_step_over_the_mesh_matches_one_process(ranks, case):
    """Loss, metrics (MoE loss, dropped share, global norm) and every leaf
    of the updated state after two steps: parameters, both moments, the
    error feedback and the step counters."""
    got = _same_on_every_rank(ranks, f"train.{case}")
    want = _one_process_train(case)
    _close(got, want)
    if "mixtral" in case:
        assert float(want["step0.moe_loss"]) > 0


@pytest.mark.parametrize("case", list(SERVE))
def test_serve_step_over_the_mesh_matches_decode_step(ranks, case):
    """Every step's logits and the final caches."""
    got = _same_on_every_rank(ranks, f"serve.{case}")
    _close(got, _one_process_serve(case))


def test_loader_rows_and_resume(ranks):
    """Each rank's rows are its chunk of the one-process batch by
    ``batch_spec`` (over "data"; the "model" ranks hold the same rows), in
    rank order, bitwise; a loader restored from ``save_state`` continues
    as the uninterrupted one."""
    from repro_torch.data.loader import TokenLoader
    one = TokenLoader(_cfg("whisper-medium"), batch=8, seq=T, device="cpu",
                      seed=5)
    want = [next(one) for _ in range(3)]
    for r, out in ranks.items():
        data = int(out["coords"][0])
        for i, b in enumerate(want):
            for k, v in b.items():
                np.testing.assert_array_equal(
                    out["loader"][f"b{i}.{k}"], _np(v[4 * data:4 * data + 4]))


def test_placement_tiles_the_full_tensor():
    """``local_shards`` at every coordinate of a (2, 3, 2) ("pod", "data",
    "model") mesh: the chunks of an axis split over ("pod", "data") are in
    row-major order (pod * 3 + data), "model" splits the other axis, a
    ``None`` entry replicates, and a host int passes through."""
    from repro_torch.models.attention import KVCache
    from repro_torch.parallel import sharding as shd
    sizes = {"pod": 2, "data": 3, "model": 2}
    full = torch.arange(12 * 4 * 5).reshape(12, 4, 5)
    spec = (("pod", "data"), "model", None)
    tree = {"a": [KVCache(full, full, 7)]}
    specs = {"a": [KVCache(spec, (None, None, None), ())]}
    assert shd.shardings(specs, sizes)["a"][0].k == shd.Placement(spec,
                                                                  sizes)
    for pod, data, model in itertools.product(range(2), range(3), range(2)):
        coords = {"pod": pod, "data": data, "model": model}
        got = shd.local_shards(tree, specs, sizes, coords=coords)["a"][0]
        i = pod * 3 + data
        assert torch.equal(got.k, full[2 * i:2 * i + 2, 2 * model:
                                       2 * model + 2])
        assert torch.equal(got.v, full) and got.length == 7
        assert got.k.is_contiguous()
    with pytest.raises(ValueError, match="does not split"):
        shd.Placement((("pod", "data"),), sizes).local_shape((8,))


def test_decode_step_moe_groups_matches_the_reference():
    """``decode_step(moe_groups=2)`` on a qwen3-moe smoke model whose
    routing groups' capacity binds (pairs drop), against the reference's,
    float32 (the reference's gather dispatch needs 64-bit types off, as
    ``test_torch_moe.py`` explains)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.models import transformer as jtf
    from repro_torch import convert
    from repro_torch.models import transformer as tf
    jcfg = jreg.smoke_config("qwen3-moe-30b-a3b").scaled(
        moe_dispatch="gather", capacity_factor=0.5)
    cfg = _cfg("qwen3-moe-30b-a3b", dict(moe_dispatch="gather",
                                         capacity_factor=0.5))
    B, steps = 8, 3
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, steps))
    with jax.enable_x64(False):
        jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
        params = convert.lm_params_from_arrays(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        dec = jax.jit(lambda p, t, s: jtf.decode_step(
            p, t, s, jcfg, moe_groups=2, compute_dtype=jnp.float32))
        jstate = jtf.init_serve(jcfg, B, 8, cache_dtype=jnp.float32)
        state = tf.init_serve(cfg, B, 8, device="cpu",
                              cache_dtype=torch.float32)
        one, _ = tf.decode_step(params, torch.tensor(toks[:, :1]),
                                tf.init_serve(cfg, B, 8, device="cpu",
                                              cache_dtype=torch.float32),
                                cfg, compute_dtype=torch.float32)
        for t in range(steps):
            jl, jstate = dec(jparams, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jstate)
            lg, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                       state, cfg, moe_groups=2,
                                       compute_dtype=torch.float32)
            # 1e-4: the same float32 graph, other summation orders
            # (test_torch_lm.py's TOL_F32)
            assert np.abs(_np(lg) - np.asarray(jl)).max() < 1e-4, t
            if t == 0:
                # two groups of 4 tokens keep other pairs than one of 8
                assert not torch.equal(lg, one)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m",
                                  "whisper-medium", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("batch", [1, 8])
def test_serve_state_specs_follow_the_reference(name, batch):
    """Each layer's cache specs are the reference's for its pattern
    position (its stacked spec without the scan axis) or its remainder
    layer's, on stub (2, 2) and (2, 2, 2) meshes; the cross K/V's too."""
    from repro.configs import registry as jreg
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    cfg = _cfg(name)
    period, n_full = cfg.period, cfg.n_layers // cfg.period * cfg.period
    for sizes in ({"data": 2, "model": 2},
                  {"pod": 2, "data": 2, "model": 2}):
        mesh = _StubMesh(sizes)
        want = jserve.serve_state_specs(jreg.smoke_config(name), mesh,
                                        batch=batch)
        got = serve.serve_state_specs(cfg, sizes, batch=batch)
        assert got.enc_kv is None
        for i, c in enumerate(got.caches):
            ref = (want.stack_caches[i % period] if i < n_full
                   else want.rest_caches[i - n_full])
            for a, b in zip(c, ref):
                b = tuple(b)
                assert a == (b[1:] if i < n_full else b), (i, a, b)
        if cfg.enc_dec:
            for i, pair in enumerate(got.cross_kv):
                ref = (want.cross_kv[0][i % period] if i < n_full
                       else want.cross_kv[1][i - n_full])
                assert pair == tuple(tuple(r)[1 if i < n_full else 0:]
                                     for r in ref)
        else:
            assert got.cross_kv is None


class _StubMesh:
    """What the reference's rules read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = shape
