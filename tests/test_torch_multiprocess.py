"""The port's GP programs over real processes: a ``ShardMapRunner`` on four
gloo ranks on the CPU, against the port's ``VmapRunner`` and the JAX
package's ``VmapRunner`` on the same arrays, in float64.

One spawn for the whole file: four processes (``torch.multiprocessing``,
spawn start method) join a process group through a ``file://`` rendezvous
in a temporary directory (no port to collide with other test workers),
each with one thread. They run the reference's multi-device script's list
(the predictions, fits and collective programs of pPITC, pPIC and pICF,
``shard_u=True`` included, ``select_support_parallel``, ``pitc_nlml``, a
("pod", "data") = (2, 2) mesh), and also one machine a rank (L = 1) and
two (L = 2), a ``fit_parallel`` step and the likelihood's gradient,
``ring_all_reduce`` over real point-to-point messages, ``compressed_psum``,
``overlapped_psum_pair`` and a store checkpoint's cross-load. They return
numpy arrays to this process. Each result is its own case against each
yardstick, within 1e-10 (1e-8 relative for the likelihood and its
gradient), pivots equal, and the four ranks' copies of a result agree bit
for bit.

A child's exception fails every case with its traceback; a child that
does not answer within JOIN_S fails them too (there is no pytest-timeout
here, so the fixture keeps its own clock). The problem is the reference's
(n = 128, u = 32, s = 12, d = 3, R = 48), M = 8 machines over four ranks
(L = 2) and M = 4 (L = 1).

The children import this module; it imports neither JAX nor ``repro`` at
the top, only inside the yardstick fixture.
"""
import functools
import os
import queue
import time
import traceback
from multiprocessing import parent_process as mp_parent

import numpy as np
import pytest
import torch

WORLD = 4
JOIN_S = 180.0
TOL = 1e-10
NLML_RTOL = 1e-8
R = 48


def _problem():
    rng = np.random.default_rng(0)
    n, u, s, d = 128, 32, 12, 3
    X, S, U = (rng.normal(size=(k, d)) for k in (n, s, u))
    y = np.sin(X[:, 0]) * 2 + X[:, 1] + 0.1 * rng.normal(size=n)
    return dict(X=X, S=S, U=U, y=y,
                ring=rng.normal(size=(8, 37, 5)),
                ring_c=rng.normal(size=(8, 64)) * 0.1,
                cpsum=rng.normal(size=(8, 256)),
                big=rng.normal(size=(8, 64, 8)), small=rng.normal(size=(8, 3)))


def _params():
    from repro_torch.core import covariance as cov
    return cov.init_params(3, signal=1.3, noise=0.3, lengthscale=1.5,
                           dtype=torch.float64, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _fields(prefix, st, out):
    for f in type(st)._fields:
        out[f"{prefix}.{f}"] = _np(getattr(st, f))


def run_programs(runner, p, params, tag="", full=True) -> dict:
    """Every program over ``runner``; the same on any runner. Returns name
    -> numpy array, the whole result on every process."""
    from repro_torch.core import covariance as cov, hyper, picf, ppic, \
        ppitc, support
    from repro_torch.optim import compression
    from repro_torch.parallel.collectives import overlapped_psum_pair, \
        ring_all_reduce
    kfn = cov.make_kernel("se")
    t = lambda k: torch.tensor(p[k])
    S, X, y, U = t("S"), t("X"), t("y"), t("U")
    out = {}
    for name, mod in (("ppitc", ppitc), ("ppic", ppic)):
        post = mod.predict_distributed(kfn, params, S, X, y, U, runner)
        out[f"{tag}{name}.predict_distributed.mean"] = _np(post.mean)
        out[f"{tag}{name}.predict_distributed.blocks"] = _np(post.blocks)
    if not full:
        return out
    for name, mod in (("ppitc", ppitc), ("ppic", ppic)):
        post = mod.predict(kfn, params, S, X, y, U, runner)
        out[f"{name}.predict.mean"] = _np(post.mean)
        out[f"{name}.predict.blocks"] = _np(post.blocks)
        _fields(f"{name}.fit", mod.fit(kfn, params, X, y, S=S,
                                       runner=runner), out)
    post = picf.predict(kfn, params, X, y, U, R, runner)
    out["picf.predict.mean"], out["picf.predict.cov"] = \
        _np(post.mean), _np(post.cov)
    post = picf.predict(kfn, params, X, y, U, R, runner, shard_u=True)
    out["picf.predict_shard_u.mean"] = _np(post.mean)
    out["picf.predict_shard_u.blocks"] = _np(post.blocks)
    post = picf.predict_distributed(kfn, params, X, y, U, R, runner)
    out["picf.predict_distributed.mean"] = _np(post.mean)
    out["picf.predict_distributed.cov"] = _np(post.cov)
    _fields("picf.fit", picf.fit(kfn, params, X, y, rank=R, runner=runner),
            out)
    loc = picf.icf_factor_local(kfn, params, runner.shard_blocks(X), R,
                                axis_name=runner.axis)
    for f in ("F", "residual"):
        out[f"icf_factor_local.{f}"] = _np(runner.gather(getattr(loc, f)))
    out["icf_factor_local.pivots"] = _np(loc.pivots[0])
    out["icf_factor_local.Lp"] = _np(loc.Lp[0])
    out["select_support_parallel"] = _np(support.select_support_parallel(
        kfn, params, X, 8, runner, device="cpu"))
    obj = lambda q: hyper.pitc_nlml(kfn, q, S, X, y, runner)
    val, grads = hyper.value_and_grad(obj, params, runner.reduce_grads)
    out["pitc_nlml"] = _np(val)
    for k, g in grads.items():
        out[f"pitc_nlml.grad.{k}"] = _np(g)
    q, losses = hyper.fit_parallel(kfn, params, S, X, y, runner, steps=2)
    out["fit_parallel.losses"] = _np(losses)
    for k, v in q.items():
        out[f"fit_parallel.{k}"] = _np(v)
    ax = runner.axis
    M = runner.num_machines
    mine = lambda k: runner.shard_blocks(t(k))[:, 0]   # (L, ...) rows
    for k, c in (("ring", False), ("ring_c", True)):
        r = ring_all_reduce(mine(k), ax, axis_size=M, compressed=c)
        out[f"ring_all_reduce.{k}"] = _np(runner.gather(r))
    out["compressed_psum"] = _np(compression.compressed_psum(
        mine("cpsum"), ax))
    b, s = overlapped_psum_pair(mine("big"), mine("small"), ax)
    out["overlapped_psum_pair.big"], out["overlapped_psum_pair.small"] = \
        _np(b), _np(s)
    return out


def _crossload(runner, p, params, tmp) -> dict:
    """A pPITC store fitted over ranks saves with opaque runner metadata,
    refuses to load without ``runner=`` (the reference's words), and loads
    bitwise with it."""
    from repro_torch.core import api, covariance as cov, serialize
    t = lambda k: torch.tensor(p[k])
    store = api.init_store("ppitc", cov.make_kernel("se"), params, t("X"),
                           t("y"), S=t("S"), runner=runner, device="cpu")
    path = serialize.save_store(os.path.join(tmp, "store.npz"), store)
    meta = serialize.peek_store(path)["runner"]
    try:
        serialize.load_store(path, device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    back = serialize.load_store(path, runner=runner, device="cpu")
    same = all(torch.equal(a, b) for a, b in
               zip(back.store.locals_ + tuple(back.store[1:]),
                   store.store.locals_ + tuple(store.store[1:])))
    return {"crossload.opaque": np.array(meta["kind"] == "opaque"),
        "crossload.refused": np.array(
            "opaque runner" in refused and "ShardMapRunner" in refused
            and "runner=<a runner for this process>" in refused),
        "crossload.bitwise": np.array(same),
        "crossload.state.alpha": _np(back.to_state().alpha)}


def _staged_ring(runner, p) -> dict:
    """The ring over an axis whose point-to-point ops take the realization
    ``BACKEND_TABLE`` gives gloo on CUDA (staged through an all-gather),
    here on CPU tensors: the same values as over ``batch_isend_irecv``."""
    import copy
    from repro_torch.parallel.collectives import ring_all_reduce
    from repro_torch.parallel.runner import BACKEND_TABLE, P2P_BY_GATHER
    staged = copy.copy(runner.axis)
    staged.table = dict(BACKEND_TABLE[("gloo", "cuda")])
    assert staged.table["p2p"] == P2P_BY_GATHER
    x = runner.shard_blocks(torch.tensor(p["ring"]))[:, 0]
    r = ring_all_reduce(x, staged, axis_size=runner.num_machines)
    return {"staged_p2p.ring": _np(runner.gather(r))}


def _child(rank, rdv, tmp, q):
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        from repro_torch.launch import mesh as tmesh
        from repro_torch.parallel.runner import ShardMapRunner, make_runner
        p, params = _problem(), _params()
        mesh = tmesh.make_mesh((WORLD,), ("data",), rank=rank,
                               world_size=WORLD,
                               init_method=f"file://{rdv}", backend="gloo",
                               device="cpu", timeout_s=JOIN_S)
        sm = ShardMapRunner(mesh=mesh, axis_name="data", local_machines=2)
        sm1 = make_runner("shard_map", mesh=mesh, axis_name="data")
        mesh2 = tmesh.make_mesh((2, 2), ("pod", "data"), rank=rank,
                                world_size=WORLD, init_method="",
                                backend="gloo", device="cpu")
        sm2 = ShardMapRunner(mesh=mesh2,
                             axis_name=tmesh.gp_machine_axes(mesh2),
                             local_machines=2)
        out = run_programs(sm, p, params)
        out.update(run_programs(sm1, p, params, tag="L1.", full=False))
        out.update(run_programs(sm2, p, params, tag="pod_data.",
                                full=False))
        out.update(_crossload(sm, p, params, os.path.join(tmp, str(rank))))
        out.update(_staged_ring(sm, p))
        out["runner.repr_is_opaque"] = np.array("ShardMapRunner" in repr(sm))
        q.put((rank, out, None))
    except Exception:
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """rank -> results of the four children (spawned first, so they run
    while the yardsticks are computed here)."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("ranks")
    for r in range(WORLD):
        (tmp / str(r)).mkdir()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, str(tmp / "rdv"),
                                              str(tmp), q), daemon=True)
             for r in range(WORLD)]
    for pr in procs:
        pr.start()
    got, errors = {}, []
    deadline = time.monotonic() + JOIN_S
    try:
        yield_ = _Yardsticks()
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
    return got, yield_


class _Yardsticks:
    """The same programs over the port's ``VmapRunner`` (M = 8, and M = 4
    for the L = 1 runs) and, where the reference has the function, over the
    JAX package's."""

    def __init__(self):
        self.port = _port_yardsticks()
        self.jax = _jax_yardsticks(_problem())


@functools.lru_cache(maxsize=None)
def _port_yardsticks() -> dict:
    from repro_torch.parallel.runner import VmapRunner
    p, params = _problem(), _params()
    out = run_programs(VmapRunner(M=8), p, params)
    out.update(run_programs(VmapRunner(M=4), p, params, tag="L1.",
                            full=False))
    out.update(run_programs(VmapRunner(M=8), p, params, tag="pod_data.",
                            full=False))
    return out


def _jax_yardsticks(p) -> dict:
    """The reference's results on the same arrays, each runner size's
    programs under one ``jax.jit`` (one compile, not one per eager op)."""
    import jax
    import jax.numpy as jnp
    from repro.core import covariance as jcov, hyper as jhyper, \
        picf as jpicf, ppic as jppic, ppitc as jppitc, support as jsupport
    from repro.optim import compression as jcomp
    from repro.parallel.collectives import overlapped_psum_pair, \
        ring_all_reduce
    from repro.parallel.runner import VmapRunner
    jax.config.update("jax_enable_x64", True)
    kfn = jcov.make_kernel("se")
    params = jcov.init_params(3, signal=1.3, noise=0.3, lengthscale=1.5,
                              dtype=jnp.float64)
    arr = {k: jnp.asarray(v) for k, v in p.items()}

    def programs(params, a, M, full):
        S, X, y, U = a["S"], a["X"], a["y"], a["U"]
        vm, out = VmapRunner(M=M), {}
        post = jppitc.predict_distributed(kfn, params, S, X, y, U, vm)
        out["ppitc.predict_distributed.mean"] = post.mean
        out["ppitc.predict_distributed.blocks"] = post.blocks
        # the port's collective pPIC is the fitted state's posterior
        # (test_torch_collective_programs says why)
        post = jppic.predict(kfn, params, S, X, y, U, vm)
        out["ppic.predict_distributed.mean"] = post.mean
        out["ppic.predict_distributed.blocks"] = post.blocks
        if not full:
            return out
        for name, mod in (("ppitc", jppitc), ("ppic", jppic)):
            post = mod.predict(kfn, params, S, X, y, U, vm)
            out[f"{name}.predict.mean"] = post.mean
            out[f"{name}.predict.blocks"] = post.blocks
            st = mod.fit(kfn, params, X, y, S=S, runner=vm)
            for f in type(st)._fields:
                out[f"{name}.fit.{f}"] = getattr(st, f)
        post = jpicf.predict(kfn, params, X, y, U, R, vm)
        out["picf.predict.mean"], out["picf.predict.cov"] = \
            post.mean, post.cov
        post = jpicf.predict(kfn, params, X, y, U, R, vm, shard_u=True)
        out["picf.predict_shard_u.mean"] = post.mean
        out["picf.predict_shard_u.blocks"] = post.blocks
        post = jpicf.predict_distributed(kfn, params, X, y, U, R, vm)
        out["picf.predict_distributed.mean"] = post.mean
        out["picf.predict_distributed.cov"] = post.cov
        st = jpicf.fit(kfn, params, X, y, rank=R, runner=vm)
        for f in type(st)._fields:
            out[f"picf.fit.{f}"] = getattr(st, f)
        loc = jpicf.factor(kfn, params, X, R, vm)
        out["icf_factor_local.F"] = loc.F
        out["icf_factor_local.residual"] = loc.residual
        out["icf_factor_local.pivots"] = loc.pivots[0]
        out["icf_factor_local.Lp"] = loc.Lp[0]
        out["select_support_parallel"] = jsupport.select_support_parallel(
            kfn, params, X, 8, vm)
        val, grads = jax.value_and_grad(lambda q: jhyper.pitc_nlml(
            kfn, q, S, X, y, vm))(params)
        out["pitc_nlml"] = val
        for k, g in grads.items():
            out[f"pitc_nlml.grad.{k}"] = g
        for k, c in (("ring", False), ("ring_c", True)):
            out[f"ring_all_reduce.{k}"] = jax.vmap(
                lambda x: ring_all_reduce(x, "m", axis_size=M, compressed=c),
                axis_name="m")(a[k])
        out["compressed_psum"] = jax.vmap(
            lambda x: jcomp.compressed_psum(x, "m"), axis_name="m")(
            a["cpsum"])[0]
        b, s = jax.vmap(lambda b, s: overlapped_psum_pair(b, s, "m"),
                        axis_name="m")(a["big"], a["small"])
        out["overlapped_psum_pair.big"] = b[0]
        out["overlapped_psum_pair.small"] = s[0]
        return out

    out = jax.jit(lambda q, a: programs(q, a, 8, True))(params, arr)
    for k, v in jax.jit(lambda q, a: programs(q, a, 4, False))(
            params, arr).items():
        out[f"L1.{k}"] = v
    for k in list(out):
        if k.startswith(("ppitc.predict_distributed",
                         "ppic.predict_distributed")):
            out[f"pod_data.{k}"] = out[k]       # the same 8 machines
    q, losses = jhyper.fit_parallel(kfn, params, arr["S"], arr["X"],
                                    arr["y"], VmapRunner(M=8), steps=2)
    out["fit_parallel.losses"] = losses
    for k, v in q.items():
        out[f"fit_parallel.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


# every result name the children return, from the port's VmapRunner run of
# the same list (which needs no process group); the children themselves
# import this module and skip it
NAMES = [] if mp_parent() is not None else sorted(_port_yardsticks())
EXACT = ("pivots", "select_support_parallel", "compressed_psum")


def _tol(name: str, want: np.ndarray) -> float:
    if any(k in name for k in EXACT):
        return 0.0
    if name.startswith(("pitc_nlml", "fit_parallel.losses")):
        return NLML_RTOL * max(1.0, float(np.abs(want).max()))
    return TOL


def _check(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= _tol(name, want), (name, err)


@pytest.mark.parametrize("name", NAMES)
def test_ranks_match_the_port_vmap_runner(results, name):
    got, ys = results
    _check(got[0][name], ys.port[name], name)


@pytest.mark.parametrize("name", NAMES)
def test_ranks_match_the_reference_vmap_runner(results, name):
    got, ys = results
    if name not in ys.jax:
        pytest.fail(f"no reference yardstick for {name}")
    _check(got[0][name], ys.jax[name], name)


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same_result(results, name):
    got, _ = results
    for r in range(1, WORLD):
        assert np.array_equal(got[r][name], got[0][name]), (r, name)


@pytest.mark.parametrize("check", ["crossload.opaque", "crossload.refused",
                                   "crossload.bitwise",
                                   "runner.repr_is_opaque"])
def test_store_fitted_over_ranks_cross_loads(results, check):
    got, _ = results
    for r in range(WORLD):
        assert bool(got[r][check]), (r, check)


def test_crossloaded_store_serves_the_fit(results):
    got, ys = results
    _check(got[0]["crossload.state.alpha"], ys.port["ppitc.fit.alpha"],
           "crossload.state.alpha")


def test_ppermute_staged_through_an_all_gather(results):
    """The gloo-on-CUDA realization of point to point (an all-gather, then
    each rank's pick) gives the ring the same values as real messages."""
    got, ys = results
    for r in range(WORLD):
        _check(got[r]["staged_p2p.ring"], ys.port["ring_all_reduce.ring"],
               "staged_p2p.ring")
