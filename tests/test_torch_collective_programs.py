"""The port's collective GP programs on the stacked machine axis (one
process, ``VmapRunner``) against the JAX package's ``VmapRunner``, whose
programs run with ``jax.vmap(axis_name=...)`` collectives, in float64 on
the CPU: pPITC's and pPIC's ``machine_step``/``predict_distributed``,
pICF's ``icf_factor_local``, ``machine_step``, ``machine_step_sharded_u``,
``predict_distributed`` and both prediction layouts, the fits,
``select_support_parallel``, the PITC likelihood and its gradient, plus
the mesh helpers' refusals and the backend table.

The problem is the reference's multi-device test's (n = 128, u = 32,
s = 12, d = 3, M = 8, R = 48), drawn with numpy from a seed. Tolerances
are ROADMAP's parity convention: 1e-10 against runner and state, 1e-8
relative for the NLML and its gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariance as jcov, hyper as jhyper, \
    picf as jpicf, ppic as jppic, ppitc as jppitc, support as jsupport
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import covariance as cov, hyper, picf, ppic, ppitc, \
    support
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import runner as trunner
from repro_torch.parallel.runner import VmapRunner

TOL = 1e-10
NLML_RTOL = 1e-8
R = 48


def _t(a):
    return torch.tensor(np.asarray(a))


def _err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    n, u, s, d, M = 128, 32, 12, 3, 8
    X, S, U = (rng.normal(size=(k, d)) for k in (n, s, u))
    y = np.sin(X[:, 0]) * 2 + X[:, 1] + 0.1 * rng.normal(size=n)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.float64)
    return dict(X=X, S=S, U=U, y=y, M=M, jparams=jparams,
                params=convert.params_from_arrays(jparams, device="cpu"),
                kfn=cov.make_kernel("se"), jkfn=jcov.make_kernel("se"),
                vm=VmapRunner(M=M), jvm=JVmapRunner(M=M))


def _j(p, *keys):
    return tuple(jnp.asarray(p[k]) for k in keys)


def _tt(p, *keys):
    return tuple(_t(p[k]) for k in keys)


def _yardstick(prob, jmod):
    """The reference's posterior the port's collective program is held to
    within TOL, and the reference's own ``predict_distributed``.

    pPITC's program is the reference's form (Sdd formed, factored by
    Cholesky with Sdd's jitter). pPIC's is the port's whitened form, whose
    Sdd factor comes from its square root with K_SS's jitter: the fitted
    state's posterior (the reference's ``predict``), as
    ``ppic.predict_from_summary`` says. The reference's collective pPIC
    factors Sdd + jitter·mean diag(Sdd), another matrix; the port is held
    to it within twice the gap that jitter makes."""
    jargs = (prob["jkfn"], prob["jparams"], *_j(prob, "S", "X", "y", "U"),
             prob["jvm"])
    dist = jmod.predict_distributed(*jargs)
    return (jmod.predict(*jargs) if jmod is jppic else dist), dist


@pytest.mark.parametrize("mod,jmod", [(ppitc, jppitc), (ppic, jppic)],
                         ids=["ppitc", "ppic"])
def test_predict_distributed_matches_reference(prob, mod, jmod):
    S, X, y, U = _tt(prob, "S", "X", "y", "U")
    got = mod.predict_distributed(prob["kfn"], prob["params"], S, X, y, U,
                                  prob["vm"])
    want, dist = _yardstick(prob, jmod)
    assert got.blocks.shape == (8, 4, 4)
    assert _err(got.mean, want.mean) < TOL
    assert _err(got.blocks, want.blocks) < TOL
    gap = max(_err(want.mean, dist.mean), _err(want.blocks, dist.blocks))
    assert _err(got.mean, dist.mean) <= max(2 * gap, TOL)
    if jmod is jppic:
        assert gap > TOL            # the jitter makes a difference here


@pytest.mark.parametrize("mod,jmod", [(ppitc, jppitc), (ppic, jppic)],
                         ids=["ppitc", "ppic"])
def test_machine_step_on_the_stacked_axis(prob, mod, jmod):
    """``machine_step`` called directly with the runner's axis object."""
    vm = prob["vm"]
    S, X, y, U = _tt(prob, "S", "X", "y", "U")
    mean, covm = mod.machine_step(prob["kfn"], prob["params"], S,
                                  vm.shard_blocks(X), vm.shard_blocks(y),
                                  vm.shard_blocks(U), axis_name=vm.axis)
    want, _ = _yardstick(prob, jmod)
    assert _err(mean.reshape(-1), want.mean) < TOL
    assert _err(covm, want.blocks) < TOL


def test_global_summary_psums_over_the_axis(prob):
    vm = prob["vm"]
    S, X, y = _tt(prob, "S", "X", "y")
    loc, glob = ppitc.summaries(prob["kfn"], prob["params"], S, X, y, vm)
    jloc, jglob = jppitc.summaries(prob["jkfn"], prob["jparams"],
                                   *_j(prob, "S", "X", "y"), prob["jvm"])
    g2 = ppitc.global_summary(prob["kfn"], prob["params"], S, loc,
                              axis_name=vm.axis)
    for got in (glob, g2):
        assert _err(got.ydd, jglob.ydd) < TOL
        assert _err(got.Sdd, jglob.Sdd) < TOL
    # the stacked axis sums as the unreduced form does, bit for bit
    Kss = prob["kfn"](prob["params"], S, S)
    assert torch.equal(Kss + loc.Sdot.sum(0), g2.Sdd)
    assert torch.equal(loc.ydot.sum(0), g2.ydd)


def test_icf_factor_local_matches_reference(prob):
    """The collective pivot loop on the stacked axis: F, residual, pivot
    inputs and Lp within 1e-10, the pivots exact copies of the
    reference's."""
    vm, M = prob["vm"], prob["M"]
    X = _t(prob["X"])
    got = picf.icf_factor_local(prob["kfn"], prob["params"],
                                vm.shard_blocks(X), R, axis_name=vm.axis)
    jX = jnp.asarray(prob["X"]).reshape(M, -1, 3)
    want = jax.vmap(lambda Xm: jpicf.icf_factor_local(
        prob["jkfn"], prob["jparams"], Xm, R, axis_name="m"),
        axis_name="m")(jX)
    for f in picf.ICFLocal._fields:
        assert _err(getattr(got, f), getattr(want, f)) < TOL, f
    assert _err(got.pivots, want.pivots) == 0.0


def test_icf_factor_local_equals_the_centralized_factor(prob):
    """Theorem 3 on the port's own routes: the loop's factor is
    ``factor``'s (one ICF over the concatenated data), pivot for pivot."""
    vm = prob["vm"]
    X = _t(prob["X"])
    loop = picf.icf_factor_local(prob["kfn"], prob["params"],
                                 vm.shard_blocks(X), R, axis_name=vm.axis)
    cen = picf.factor(prob["kfn"], prob["params"], X, R, vm)
    assert torch.equal(loop.pivots, cen.pivots)
    assert _err(loop.F, cen.F) < TOL and _err(loop.Lp, cen.Lp) < TOL


def test_picf_global_pieces_match_reference(prob):
    vm, M = prob["vm"], prob["M"]
    X, y, U = _tt(prob, "X", "y", "U")
    loc = picf.factor(prob["kfn"], prob["params"], X, R, vm)
    Kud = prob["kfn"](prob["params"], U, vm.shard_blocks(X))
    Sdot = loc.F @ Kud.mT
    ydd, Sdd = picf._global_pieces(prob["params"], loc.F, vm.shard_blocks(y),
                                   Sdot, axis_name=vm.axis)
    jF = jnp.asarray(loc.F.numpy())
    jSdot = jnp.asarray(Sdot.numpy())
    jydd, jSdd = jax.vmap(lambda F, ym, Sd: jpicf._global_pieces(
        prob["jparams"], F, ym, Sd, axis_name="m"), axis_name="m")(
        jF, jnp.asarray(prob["y"]).reshape(M, -1), jSdot)
    assert ydd.dtype == torch.float64
    assert _err(ydd, jydd[0]) < TOL and _err(Sdd, jSdd[0]) < TOL


@pytest.mark.parametrize("layout", ["distributed", "replicated",
                                    "sharded_u"])
def test_picf_prediction_layouts_match_reference(prob, layout):
    """``predict_distributed`` (``machine_step``), ``predict`` (fit +
    predict_batch) and ``predict(shard_u=True)``
    (``machine_step_sharded_u``)."""
    X, y, U = _tt(prob, "X", "y", "U")
    jX, jy, jU = _j(prob, "X", "y", "U")
    args = (prob["kfn"], prob["params"], X, y, U, R, prob["vm"])
    jargs = (prob["jkfn"], prob["jparams"], jX, jy, jU, R, prob["jvm"])
    if layout == "distributed":
        got, want = picf.predict_distributed(*args), \
            jpicf.predict_distributed(*jargs)
        pairs = [(got.mean, want.mean), (got.cov, want.cov)]
    else:
        kw = {"shard_u": layout == "sharded_u"}
        got, want = picf.predict(*args, **kw), jpicf.predict(*jargs, **kw)
        pairs = [(got.mean, want.mean), (got.cov, want.cov)]
        if layout == "sharded_u":
            assert got.blocks.shape == (8, 4, 4)
            pairs.append((got.blocks, want.blocks))
    for g, w in pairs:
        assert _err(g, w) < TOL


@pytest.mark.parametrize("method", ["ppitc", "ppic", "picf"])
def test_fits_over_the_vmap_runner_match_reference(prob, method):
    S, X, y = _tt(prob, "S", "X", "y")
    jS, jX, jy = _j(prob, "S", "X", "y")
    mod, jmod = {"ppitc": (ppitc, jppitc), "ppic": (ppic, jppic),
                 "picf": (picf, jpicf)}[method]
    if method == "picf":
        got = mod.fit(prob["kfn"], prob["params"], X, y, rank=R,
                      runner=prob["vm"])
        want = jmod.fit(prob["jkfn"], prob["jparams"], jX, jy, rank=R,
                        runner=prob["jvm"])
    else:
        got = mod.fit(prob["kfn"], prob["params"], X, y, S=S,
                      runner=prob["vm"])
        want = jmod.fit(prob["jkfn"], prob["jparams"], jX, jy, S=jS,
                        runner=prob["jvm"])
    assert type(got)._fields == type(want)._fields
    for f in type(got)._fields:
        assert _err(getattr(got, f), getattr(want, f)) < TOL, f


def test_select_support_parallel_matches_reference(prob):
    got = support.select_support_parallel(
        prob["kfn"], prob["params"], _t(prob["X"]), 10, prob["vm"],
        device="cpu")
    want = jsupport.select_support_parallel(
        prob["jkfn"], prob["jparams"], jnp.asarray(prob["X"]), 10,
        prob["jvm"])
    assert _err(got, want) == 0.0


def _rel(a, b) -> float:
    return _err(a, b) / max(1.0, float(np.abs(np.asarray(b)).max()))


def test_pitc_nlml_and_gradient_match_reference(prob):
    S, X, y = _tt(prob, "S", "X", "y")
    jS, jX, jy = _j(prob, "S", "X", "y")
    obj = lambda p: hyper.pitc_nlml(prob["kfn"], p, S, X, y, prob["vm"])
    val, grads = hyper.value_and_grad(obj, prob["params"],
                                      prob["vm"].reduce_grads)
    jval, jgrads = jax.value_and_grad(lambda p: jhyper.pitc_nlml(
        prob["jkfn"], p, jS, jX, jy, prob["jvm"]))(prob["jparams"])
    assert _rel(val, jval) < NLML_RTOL
    for k in grads:
        assert _rel(grads[k], jgrads[k]) < NLML_RTOL, k


def test_pitc_nlml_machine_takes_the_axis(prob):
    vm = prob["vm"]
    S, X, y = _tt(prob, "S", "X", "y")
    args = (prob["kfn"], prob["params"], S, vm.shard_blocks(X),
            vm.shard_blocks(y))
    a = hyper.pitc_nlml_machine(*args, axis_name=vm.axis)
    b = hyper.pitc_nlml_machine(*args)
    assert torch.equal(a, b)


def test_fit_parallel_one_step_matches_reference(prob):
    S, X, y = _tt(prob, "S", "X", "y")
    p, losses = hyper.fit_parallel(prob["kfn"], prob["params"], S, X, y,
                                   prob["vm"], steps=2, lr=0.05)
    jp, jlosses = jhyper.fit_parallel(prob["jkfn"], prob["jparams"],
                                      *_j(prob, "S", "X", "y"), prob["jvm"],
                                      steps=2, lr=0.05)
    assert _rel(losses, jlosses) < NLML_RTOL
    for k in p:
        assert _err(p[k], jp[k]) < 1e-8, k


# -- mesh helpers and the backend table (no process group needed) ----------

def test_nccl_refuses_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        tmesh._check_nccl("nccl", torch.device("cuda", 0),
                          torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="needs CUDA devices"):
        tmesh._check_nccl("nccl", torch.device("cpu"), 1)
    tmesh._check_nccl("gloo", torch.device("cpu"), 8)       # gloo shares


@pytest.mark.parametrize("multi_pod,world", [(False, 4), (True, 256)])
def test_production_mesh_needs_its_world(multi_pod, world):
    with pytest.raises(ValueError, match="needs (256|512) ranks"):
        tmesh.make_production_mesh(multi_pod=multi_pod, rank=0,
                                   world_size=world,
                                   init_method="file:///nonexistent")


def test_make_mesh_checks_shape_before_joining():
    with pytest.raises(ValueError, match="holds 4 ranks"):
        tmesh.make_mesh((2, 2), ("pod", "data"), rank=0, world_size=3,
                        init_method="file:///nonexistent", backend="gloo",
                        device="cpu")


def test_gp_machine_axes():
    class Fake:
        mesh_dim_names = ("pod", "data", "model")
    assert tmesh.gp_machine_axes(Fake()) == ("pod", "data")
    Fake.mesh_dim_names = ("data", "model")
    assert tmesh.gp_machine_axes(Fake()) == ("data",)


def test_rank_device_names_the_card_or_raises():
    assert tmesh.rank_device(3, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tmesh.rank_device(0)


def test_backend_table_covers_each_collective():
    rows = trunner.backend_table()
    keys = {(r["backend"], r["device"]) for r in rows}
    assert keys == {("nccl", "cuda"), ("gloo", "cpu"), ("gloo", "cuda")}
    for key in keys:
        assert set(trunner.BACKEND_TABLE[key]) == {
            "all_reduce", "all_gather", "reduce_scatter", "p2p"}
    # what gloo cannot carry for CUDA tensors is written out, and says so
    staged = [r for r in rows if "note" in r]
    assert [(r["backend"], r["device"], r["op"]) for r in staged] == [
        ("gloo", "cuda", "p2p")]


def test_stacked_axis_collectives():
    ax = VmapRunner(M=4).axis
    x = torch.arange(24, dtype=torch.float64).reshape(4, 6)
    assert torch.equal(ax.psum(x), x.sum(0))
    assert torch.equal(ax.pmax(x), x[3])
    assert torch.equal(ax.all_gather(x), x)
    assert torch.equal(ax.index(), torch.arange(4))
    ring = [(i, (i + 1) % 4) for i in range(4)]
    assert torch.equal(ax.ppermute(x, ring), torch.roll(x, 1, 0))
    part = ax.ppermute(x, [(0, 2)])
    assert torch.equal(part[2], x[0]) and not part[[0, 1, 3]].any()
    blocks = torch.arange(4 * 4 * 2, dtype=torch.float64).reshape(4, 4, 2)
    assert torch.equal(ax.psum_scatter(blocks), blocks.sum(0))
    assert ax.stats["psum:calls"] == 1 and ax.stats["ppermute:calls"] == 2
    with pytest.raises(ValueError, match="stack of this process's 4"):
        ax.psum(x[:3])


def test_make_runner():
    r = trunner.make_runner("vmap", M=5)
    assert r == VmapRunner(M=5) and r.axis.size == 5
    with pytest.raises(ValueError, match="unknown runner mode"):
        trunner.make_runner("pmap", M=5)
    with pytest.raises(ValueError, match="needs a DeviceMesh"):
        trunner.make_runner("shard_map")
