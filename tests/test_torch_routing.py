"""The port's routed layouts, clustering and routing invariants, against the
JAX package on the CPU.

* Layout indices of ``scatter_by_block``/``scatter_two_bucket`` (and their
  gathers) equal the reference's exactly, over balanced, skewed and
  ``max_groups``-limited assignments, several n and M, and tile > 1.
* ``routed_capacity`` and ``ppic._snap_groups`` equal the reference's over a
  grid; ``capacity_assign``/``cocluster``/``uncluster`` equal it given the
  same centers.
* The port's own invariants, re-proved in torch: permutation invariance
  (bitwise), re-chunking invariance (1e-10 in float64), the two-bucket
  layout equal to the capacity layout (bitwise in float32, 1e-12 in
  float64, the reference's F64_LAYOUT_TOL), skewed traffic.
* Routed pPIC within ORACLE_TOL = 5e-6 of the reference's literal routed
  PIC oracle; the port's own literal oracles within 1e-10 of the
  reference's.

Seeded ``pytest.mark.parametrize`` cases replace the reference's
hypothesis properties (no deadlines; every case counts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclustering, covariance as jcov, \
    pitc as jpitc, ppic as jppic
from repro.parallel import runner as jrunner
from repro_torch import convert
from repro_torch.core import clustering, covariance as cov, pitc, ppic
from repro_torch.parallel import runner
from repro_torch.parallel.runner import VmapRunner

ORACLE_TOL = 5e-6
STATE_TOL = 1e-10
RECHUNK_TOL = 1e-10
F64_LAYOUT_TOL = 1e-12
SEEDS = range(10)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _err(got, want) -> float:
    return float(np.abs(_np(got).astype(np.float64)
                        - _np(want).astype(np.float64)).max())


def _problem(dtype=np.float64, seed=0):
    """tests/helpers.make_problem's shapes (n=96, u=24, |S|=12, d=3, M=4),
    drawn with numpy from a seed."""
    rng = np.random.default_rng(seed)
    n, u, s, d, M = 96, 24, 12, 3, 4
    X, S, U = (rng.normal(size=(k, d)).astype(dtype) for k in (n, s, u))
    y = (np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2
         + 0.3 * rng.normal(size=n)).astype(dtype)
    return dict(X=X, y=y, S=S, U=U, M=M)


def _params(d, dtype):
    return cov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                           dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def prob():
    p = _problem()
    p["params"] = _params(3, torch.float64)
    p["kfn"] = cov.make_kernel("se")
    p["state"] = ppic.fit(p["kfn"], p["params"], _t(p["X"]), _t(p["y"]),
                          S=_t(p["S"]), runner=VmapRunner(M=p["M"]))
    p["base"] = ppic.predict_routed_diag(p["kfn"], p["params"], p["state"],
                                         _t(p["U"]))
    return p


@pytest.fixture(scope="module")
def prob32():
    p = _problem(np.float32)
    p["params"] = _params(3, torch.float32)
    p["kfn"] = cov.make_kernel("se")
    p["state"] = ppic.fit(p["kfn"], p["params"], _t(p["X"]), _t(p["y"]),
                          S=_t(p["S"]), runner=VmapRunner(M=p["M"]))
    return p


# ---------------------------------------------------------------------------
# Layout indices: exactly the reference's.
# ---------------------------------------------------------------------------

def _assign(kind: str, n: int, M: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, M, size=n)
    if kind == "skewed":                      # every row on one block
        return np.full(n, int(rng.integers(0, M)))
    # "two": most rows on two blocks, a few elsewhere
    a = rng.choice([0, M - 1], size=n)
    a[rng.random(n) < 0.1] = rng.integers(0, M)
    return a


_LAYOUT_FIELDS = ("order", "block_of", "rank", "group", "slot_o", "in_main")


def _check_layout(n, M, kind, seed, tile=1, max_groups=None):
    rng = np.random.default_rng(100 + seed)
    X = rng.normal(size=(n, 3))
    a = _assign(kind, n, M, seed)
    lay = runner.scatter_two_bucket(_t(X), _t(a), M, tile=tile,
                                    max_groups=max_groups)
    jlay = jrunner.scatter_two_bucket(jnp.asarray(X), jnp.asarray(a), M,
                                      tile=tile, max_groups=max_groups)
    for f in _LAYOUT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(lay, f)),
                                      np.asarray(getattr(jlay, f)), err_msg=f)
    np.testing.assert_array_equal(lay.Xb.numpy(), np.asarray(jlay.Xb))
    assert (lay.Xo is None) == (jlay.Xo is None)
    if lay.Xo is not None:
        np.testing.assert_array_equal(lay.Xo.numpy(), np.asarray(jlay.Xo))
        np.testing.assert_array_equal(lay.o_blk.numpy(),
                                      np.asarray(jlay.o_blk))
    assert lay.padded_rows == jlay.padded_rows
    # the gather of per-row outputs (here: the first coordinate)
    vo = None if lay.Xo is None else lay.Xo[..., 0]
    jvo = None if jlay.Xo is None else jlay.Xo[..., 0]
    np.testing.assert_array_equal(
        runner.gather_two_bucket(lay.Xb[..., 0], vo, lay).numpy(),
        np.asarray(jrunner.gather_two_bucket(jlay.Xb[..., 0], jvo, jlay)))


@pytest.mark.parametrize("kind", ["random", "skewed", "two"])
@pytest.mark.parametrize("n,M", [(1, 1), (7, 3), (24, 4), (40, 4), (33, 9),
                                 (64, 8)])
def test_two_bucket_layout_matches_reference(n, M, kind):
    _check_layout(n, M, kind, seed=n + M)


@pytest.mark.parametrize("kind", ["random", "skewed", "two"])
@pytest.mark.parametrize("tile,max_groups", [(8, None), (4, 1), (1, 0),
                                             (1, 1), (16, 2)])
def test_two_bucket_layout_tile_and_max_groups_match_reference(
        tile, max_groups, kind):
    _check_layout(40, 6, kind, seed=tile + 3 * (max_groups or 0),
                  tile=tile, max_groups=max_groups)


@pytest.mark.parametrize("kind", ["random", "skewed", "two"])
@pytest.mark.parametrize("n,M", [(1, 1), (9, 4), (24, 4), (30, 7)])
def test_scatter_by_block_matches_reference(n, M, kind):
    rng = np.random.default_rng(n * M)
    X = rng.normal(size=(n, 2))
    a = _assign(kind, n, M, n)
    out = runner.scatter_by_block(_t(X), _t(a), M)
    jout = jrunner.scatter_by_block(jnp.asarray(X), jnp.asarray(a), M)
    for got, want in zip(out, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    Xb, order, block_of, slot = out
    np.testing.assert_array_equal(
        runner.gather_by_block(Xb, order, block_of, slot).numpy(), X)


def test_routed_capacity_matches_reference_over_a_grid():
    for n in range(1, 70):
        for M in (1, 2, 3, 4, 8, 9, 20):
            for alpha in (1, 2, 3):
                for tile in (1, 8):
                    for mg in (None, 0, 1, 3):
                        kw = dict(alpha=alpha, tile=tile, max_groups=mg)
                        assert runner.routed_capacity(n, M, **kw) == \
                            jrunner.routed_capacity(n, M, **kw)


def test_snap_groups_matches_reference_over_a_grid():
    for needed in range(0, 12):
        for G_full in range(0, 12):
            for mg in (None, 0, 1, 2, 5):
                assert ppic._snap_groups(needed, G_full, mg) == \
                    jppic._snap_groups(needed, G_full, mg)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,m", [(1, 1), (13, 3), (40, 9)])
def test_scatter_gather_roundtrip(seed, n, m):
    """Every row lands in exactly one bucket slot and gathers back; each
    overflow group serves the block its rows were assigned to."""
    rng = np.random.RandomState(seed)
    X = torch.tensor(rng.randn(n, 3))
    assign = torch.tensor(rng.randint(0, m, size=n))
    lay = runner.scatter_two_bucket(X, assign, m)
    out = runner.gather_two_bucket(
        lay.Xb[..., 0], None if lay.Xo is None else lay.Xo[..., 0], lay)
    assert torch.equal(out, X[:, 0])
    if lay.Xo is not None:
        for j in range(n):
            if not bool(lay.in_main[j]):
                assert int(assign[lay.order[j]]) == \
                    int(lay.o_blk[lay.group[j]])


def test_padded_rows_reduction_at_m8():
    for n in (32, 64, 256):
        cap, G = runner.routed_capacity(n, 8)
        assert 8 * n / ((8 + G) * cap) >= 2.0


def test_tile_alignment():
    cap, _ = runner.routed_capacity(50, 8, tile=16)
    assert cap % 16 == 0


# ---------------------------------------------------------------------------
# Clustering: the reference's, given the same centers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,M", [(96, 4), (100, 7), (60, 20)])
def test_capacity_assign_matches_reference(n, M):
    rng = np.random.default_rng(n + M)
    X = rng.normal(size=(n, 3))
    centers = X[rng.choice(n, size=M, replace=False)]
    cap = -(-n // M)
    a = clustering.capacity_assign(X, centers, cap)
    np.testing.assert_array_equal(
        a, jclustering.capacity_assign(X, centers, cap))
    assert np.bincount(a, minlength=M).max() <= cap
    with pytest.raises(ValueError, match="cannot hold"):
        clustering.capacity_assign(X, centers, cap - 1 if n % M else
                                   n // M - 1)


def test_cocluster_and_uncluster_match_reference(monkeypatch):
    """Given the reference's proposals (its random stream is JAX's), the
    port co-clusters exactly as the reference does."""
    p = _problem()
    key = jax.random.PRNGKey(3)
    centers = jclustering.propose_centers(p["X"], p["M"], key)
    monkeypatch.setattr(clustering, "propose_centers",
                        lambda X, M, rng: centers)
    got = clustering.cocluster(p["X"], p["y"], p["U"], p["M"], None)
    want = jclustering.cocluster(p["X"], p["y"], p["U"], p["M"], key)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    vals = np.arange(p["U"].shape[0], dtype=np.float64) * 1.5
    np.testing.assert_array_equal(
        clustering.uncluster(vals, got[4]),
        jclustering.uncluster(vals, np.asarray(want[4])))
    np.testing.assert_array_equal(clustering.uncluster(got[2], got[4]),
                                  p["U"])


def test_propose_centers_takes_one_point_per_block_from_its_seed():
    X = np.arange(40, dtype=np.float64).reshape(20, 2)
    c = clustering.propose_centers(X, 4, 7)
    np.testing.assert_array_equal(c, clustering.propose_centers(
        X, 4, np.random.default_rng(7)))
    rows = (c[:, 0] / 2).astype(int)
    np.testing.assert_array_equal(rows // 5, np.arange(4))


def test_nearest_center_and_centroids_match_reference():
    p = _problem()
    centers = p["X"][:5]
    np.testing.assert_array_equal(
        clustering.nearest_center_np(p["U"], centers),
        jclustering.nearest_center_np(p["U"], centers))
    Xb = p["X"].reshape(4, 24, 3)
    assert _err(clustering.block_centroids(_t(Xb)),
                jclustering.block_centroids(jnp.asarray(Xb))) < 1e-15


def test_route_queries_matches_reference(prob):
    jstate = jppic.fit(jcov.make_kernel("se"), _jparams(), jnp.asarray(
        prob["X"]), jnp.asarray(prob["y"]), S=jnp.asarray(prob["S"]),
        runner=jrunner.VmapRunner(M=prob["M"]))
    state = convert.state_from_arrays(jstate, device="cpu")
    np.testing.assert_array_equal(
        ppic.route_queries(state, _t(prob["U"])).numpy(),
        np.asarray(jppic.route_queries(jstate, jnp.asarray(prob["U"]))))
    np.testing.assert_array_equal(
        ppic.route_queries(state, _t(prob["U"])).numpy(),
        clustering.nearest_center_np(prob["U"], state.centroids.numpy()))


def _jparams():
    return jcov.init_params(3, signal=1.3, noise=0.3, lengthscale=1.5,
                            dtype=jnp.float64)


# ---------------------------------------------------------------------------
# The port's own routing invariants.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_is_bitwise_invariant(prob, seed):
    perm = np.random.RandomState(seed).permutation(prob["U"].shape[0])
    m, v = ppic.predict_routed_diag(prob["kfn"], prob["params"],
                                    prob["state"], _t(prob["U"][perm]))
    assert torch.equal(m, prob["base"][0][perm])
    assert torch.equal(v, prob["base"][1][perm])


@pytest.mark.parametrize("seed,chunk", [(s, c) for s in range(5)
                                        for c in (1, 3, 7, 11)])
def test_rechunking_is_invariant(prob, seed, chunk):
    u = prob["U"].shape[0]
    perm = np.random.RandomState(seed).permutation(u)
    Up = _t(prob["U"][perm])
    parts = [ppic.predict_routed_diag(prob["kfn"], prob["params"],
                                      prob["state"], Up[i:i + chunk])
             for i in range(0, u, chunk)]
    m = torch.cat([p[0] for p in parts])
    v = torch.cat([p[1] for p in parts])
    assert _err(m, prob["base"][0][perm]) < RECHUNK_TOL
    assert _err(v, prob["base"][1][perm]) < RECHUNK_TOL


def test_routing_is_pure_in_the_query(prob):
    whole = ppic.route_queries(prob["state"], _t(prob["U"]))
    for i in range(prob["U"].shape[0]):
        one = ppic.route_queries(prob["state"], _t(prob["U"][i:i + 1]))
        assert int(one[0]) == int(whole[i])


def test_positional_path_is_composition_dependent(prob):
    m, _ = ppic.predict_batch_diag(prob["kfn"], prob["params"],
                                   prob["state"], _t(prob["U"]))
    perm = np.random.RandomState(0).permutation(prob["U"].shape[0])
    mp, _ = ppic.predict_batch_diag(prob["kfn"], prob["params"],
                                    prob["state"], _t(prob["U"][perm]))
    assert float((mp - m[perm]).abs().max()) > 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_two_bucket_equals_capacity_layout_bitwise_f32(prob32, seed):
    perm = np.random.RandomState(seed).permutation(prob32["U"].shape[0])
    Up = _t(prob32["U"][perm])
    args = (prob32["kfn"], prob32["params"], prob32["state"], Up)
    m_c, v_c = ppic.predict_routed_diag_capacity(*args)
    m_t, v_t = ppic.predict_routed_diag(*args)
    assert m_t.dtype == torch.float32
    assert torch.equal(m_t, m_c) and torch.equal(v_t, v_c)


@pytest.mark.parametrize("seed", SEEDS)
def test_two_bucket_equals_capacity_layout_f64(prob, seed):
    perm = np.random.RandomState(seed).permutation(prob["U"].shape[0])
    args = (prob["kfn"], prob["params"], prob["state"],
            _t(prob["U"][perm]))
    m_c, v_c = ppic.predict_routed_diag_capacity(*args)
    m_t, v_t = ppic.predict_routed_diag(*args)
    assert _err(m_t, m_c) < F64_LAYOUT_TOL
    assert _err(v_t, v_c) < F64_LAYOUT_TOL


@pytest.mark.parametrize("target", range(4))
def test_skewed_traffic_overflows_and_still_matches(prob32, target):
    """All queries on one centroid: the main bucket overflows into the skew
    groups, which serve the same block program (bitwise)."""
    c = prob32["state"].centroids[target]
    rng = np.random.RandomState(7 + target)
    Uskew = c[None, :] + 0.01 * torch.tensor(rng.randn(20, 3)).float()
    assign = ppic.route_queries(prob32["state"], Uskew)
    assert bool((assign == target).all())           # genuinely skewed
    cap, G = runner.routed_capacity(20, prob32["M"])
    assert G > 0 and cap < 20                       # overflow exercised
    args = (prob32["kfn"], prob32["params"], prob32["state"], Uskew)
    m_c, v_c = ppic.predict_routed_diag_capacity(*args)
    m_t, v_t = ppic.predict_routed_diag(*args)
    assert torch.equal(m_t, m_c) and torch.equal(v_t, v_c)


# ---------------------------------------------------------------------------
# Oracles.
# ---------------------------------------------------------------------------

def _jax_oracle(prob, fn, *extra):
    return fn(jcov.make_kernel("se"), _jparams(), jnp.asarray(prob["S"]),
              jnp.asarray(prob["X"]), jnp.asarray(prob["y"]),
              jnp.asarray(prob["U"]), prob["M"], *extra)


def _oracle(prob, fn, *extra):
    return fn(prob["kfn"], prob["params"], _t(prob["S"]), _t(prob["X"]),
              _t(prob["y"]), _t(prob["U"]), prob["M"], *extra)


def test_routed_matches_reference_routed_literal_oracle(prob):
    """Thm 2 + Remark 2: the port's cached-factor routed pPIC is the
    reference's literal centralized PIC with the same per-query block."""
    assign = ppic.route_queries(prob["state"], _t(prob["U"])).numpy()
    lit = _jax_oracle(prob, jpitc.pic_predict_literal_routed, assign)
    assert _err(prob["base"][0], lit.mean) < ORACLE_TOL
    assert _err(prob["base"][1], jnp.diag(lit.cov)) < ORACLE_TOL
    post = ppic.predict_routed(prob["kfn"], prob["params"], prob["state"],
                               _t(prob["U"]))
    same = assign[:, None] == assign[None, :]
    assert float(np.abs(post.cov.numpy() - np.asarray(lit.cov))[same].max()
                 ) < ORACLE_TOL
    assert _err(post.mean, prob["base"][0]) < 1e-12
    assert _err(torch.diagonal(post.cov), prob["base"][1]) < 1e-10


@pytest.mark.parametrize("name", ["pitc_predict_literal",
                                  "pic_predict_literal",
                                  "pic_predict_literal_routed",
                                  "pitc_predict_blockwise",
                                  "pic_predict_blockwise"])
def test_literal_and_blockwise_oracles_match_reference(prob, name):
    extra = ()
    if name.endswith("routed"):
        extra = (ppic.route_queries(prob["state"], _t(prob["U"])).numpy(),)
    post = _oracle(prob, getattr(pitc, name), *extra)
    jpost = _jax_oracle(prob, getattr(jpitc, name), *extra)
    assert _err(post.mean, jpost.mean) < STATE_TOL
    assert _err(post.cov, jpost.cov) < STATE_TOL


def test_ppic_equals_pic(prob):
    """Theorem 2 in the port alone: pPIC's block posterior is the literal
    centralized PIC."""
    lit = _oracle(prob, pitc.pic_predict_literal)
    post = ppic.predict(prob["kfn"], prob["params"], _t(prob["S"]),
                        _t(prob["X"]), _t(prob["y"]), _t(prob["U"]),
                        VmapRunner(M=prob["M"]))
    assert _err(post.mean, lit.mean) < ORACLE_TOL
    assert _err(post.var, torch.diagonal(lit.cov)) < ORACLE_TOL
    b = prob["U"].shape[0] // prob["M"]
    for m in range(prob["M"]):
        sl = slice(m * b, (m + 1) * b)
        assert _err(post.blocks[m], lit.cov[sl, sl]) < ORACLE_TOL
