"""The port's GP programs over a ``ShardMapRunner`` of ONE rank (a gloo
group of one process, this one, on the CPU), against the port's
``VmapRunner`` on the same arrays, in float64.

A one-rank ``DistAxis`` takes the collective route, not the stacked one:
the fits' TSQR and gathers, pICF's pivot loop (``icf_factor_local``, not
one ICF over the inputs) and the collective ``select_support_parallel``,
each through the group's own collectives. It is how one NCCL rank runs on
a card. The programs are ``tests/test_torch_multiprocess.py``'s list, with
every machine on the one rank (L = 8, and L = 4 for the ``L1.`` runs);
each result is its own case, within 1e-10 (1e-8 relative for the
likelihood and its gradient), pivots equal.
"""
import numpy as np
import pytest
import torch

import test_torch_multiprocess as mpt

NAMES = [n for n in mpt.NAMES if not n.startswith("pod_data.")]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    if dist.is_initialized():
        pytest.fail("a process group is already initialized here")
    rdv = tmp_path_factory.mktemp("one_rank") / "rdv"
    m = tmesh.make_mesh((1,), ("data",), rank=0, world_size=1,
                        init_method=f"file://{rdv}", backend="gloo",
                        device="cpu", timeout_s=60.0)
    try:
        yield m
    finally:
        dist.destroy_process_group()


def _runner(mesh, L):
    from repro_torch.parallel.runner import ShardMapRunner
    return ShardMapRunner(mesh=mesh, axis_name="data", local_machines=L)


@pytest.fixture(scope="module")
def results(mesh):
    p, params = mpt._problem(), mpt._params()
    out = mpt.run_programs(_runner(mesh, 8), p, params)
    out.update(mpt.run_programs(_runner(mesh, 4), p, params, tag="L1.",
                                full=False))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_one_rank_matches_the_port_vmap_runner(results, name):
    mpt._check(results[name], mpt._port_yardsticks()[name], name)


def test_one_rank_axis_is_distributed(mesh):
    ax = _runner(mesh, 8).axis
    assert ax.distributed and ax.ranks == 1 and ax.local == ax.size == 8
    assert ax.backend == "gloo"


@pytest.mark.parametrize("program", ["ppitc.fit", "picf.fit", "pitc_nlml"])
def test_one_rank_fit_takes_the_tsqr(mesh, program):
    """Sdd's (Phi's) factor is the TSQR across ranks: one all-gather of the
    rank's triangle, and the machine sums one psum over the group."""
    from repro_torch.core import covariance as cov, hyper, picf, ppitc
    p, params = mpt._problem(), mpt._params()
    t = lambda k: torch.tensor(p[k])
    kfn, sm = cov.make_kernel("se"), _runner(mesh, 8)
    ax = sm.axis
    fits = {
        "ppitc.fit": lambda: ppitc.fit(kfn, params, t("X"), t("y"),
                                       S=t("S"), runner=sm),
        "pitc_nlml": lambda: hyper.pitc_nlml(kfn, params, t("S"), t("X"),
                                             t("y"), sm)}
    if program == "picf.fit":
        local = picf.factor(kfn, params, t("X"), mpt.R, sm)
        ax.reset_stats()
        picf.init_picf_store(kfn, params, t("X"), t("y"), rank=mpt.R,
                             runner=sm, local=local)
    else:
        ax.reset_stats()
        fits[program]()
    assert ax.stats["all_gather:calls"] >= 1, dict(ax.stats)
    assert ax.stats["psum:calls"] >= 1, dict(ax.stats)


def test_one_rank_factor_is_the_pivot_loop(mesh):
    """pICF's factor on a one-rank ``ShardMapRunner`` is the collective
    loop: per step one all-gather of the local maxima and one masked psum,
    and its pivots are the stacked factor's."""
    from repro_torch.core import covariance as cov, picf
    from repro_torch.parallel.runner import VmapRunner
    p, params = mpt._problem(), mpt._params()
    X = torch.tensor(p["X"])
    kfn, sm = cov.make_kernel("se"), _runner(mesh, 8)
    sm.axis.reset_stats()
    loc = picf.factor(kfn, params, X, mpt.R, sm)
    assert sm.axis.stats["all_gather:calls"] == mpt.R
    assert sm.axis.stats["psum:calls"] == mpt.R
    want = picf.factor(kfn, params, X, mpt.R, VmapRunner(M=8))
    assert torch.equal(loc.pivots[0], want.pivots[0])
    assert float((loc.F - want.F).abs().max()) <= mpt.TOL


@pytest.mark.parametrize("op", ["psum_scatter", "ppermute", "all_gather"])
def test_one_rank_axis_ops_match_the_stacked_axis(mesh, op):
    from repro_torch.parallel.runner import VmapRunner
    x = torch.tensor(np.random.default_rng(3).normal(size=(8, 8, 5)))
    dist_ax, st_ax = _runner(mesh, 8).axis, VmapRunner(M=8).axis
    ring = [(i, (i + 1) % 8) for i in range(8)]
    call = {"psum_scatter": lambda a: a.psum_scatter(x),
            "ppermute": lambda a: a.ppermute(x, ring),
            "all_gather": lambda a: a.all_gather(x)}[op]
    assert torch.equal(call(dist_ax), call(st_ax))
