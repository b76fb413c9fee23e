"""The fixed-order row products of pPIC's serving diag
(``kernels/linalg``: ``rows_mm``, ``rows_reduce``) and the routed program
built on them, on the CPU.

* The plain versions against float64 products and dots in numpy (1e-12 of
  1 + |value|: the sums are over at most a few hundred terms of size
  O(1)), over shared and tabled B, ``trans``, ``lower``, C0 and a K that is
  not a whole number of k-steps.
* A row's output is the same bits alone, at another slot, or inside a
  larger batch of blocks (``torch.equal``), in float32 and float64.
* The routed program through them within 1e-10 of the JAX package's
  ``predict_routed_diag`` in float64 (the reference's state tolerance,
  tests/test_shardmap.py); the two-bucket and capacity-|U| layouts
  bitwise in float32 and float64, overflow groups included.
* A plan builds its tables once per state and again on ``rebind``; the
  overflow groups read the tables in place (no copy of their owner's
  factors), in one batch with the main bucket.

Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi, covariance as jcov, ppic as jppic
from repro.parallel.runner import VmapRunner as JVmapRunner
from repro_torch import convert
from repro_torch.core import api, covariance as cov, ppic
from repro_torch.kernels.linalg import ops as lops, ref as lref
from repro_torch.kernels.rbf import ops as rbf_ops
from repro_torch.parallel import runner
from repro_torch.parallel.runner import VmapRunner

PLAIN_TOL = 1e-12
STATE_TOL = 1e-10


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _rel(got, want) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float((np.abs(g - w) / (1.0 + np.abs(w))).max())


def _operands(seed, nblk, u, K, N, *, trans, lower, table, c0):
    """X (nblk, u, K); B shared (P, Q) or a table (nt, P, Q) with an index;
    C0 or None; and op(B_e) per block as numpy arrays."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(nblk, u, K))
    P, Q = (N, K) if trans else (K, N)
    nt = nblk + 2 if table else 1
    B = rng.normal(size=(nt, P, Q))
    if lower:
        B = np.tril(B)
    idx = rng.integers(0, nt, size=nblk) if table else np.zeros(nblk, int)
    ops_b = [B[e].T if trans else B[e] for e in idx]
    C0 = rng.normal(size=(nblk, u, N)) if c0 else None
    Bt = _t(B) if table else _t(B[0])
    return (_t(X), Bt, _t(idx) if table else None,
            None if C0 is None else _t(C0), X, ops_b, C0)


CASES = [dict(trans=t, lower=lo, table=tb, c0=c)
         for t in (False, True) for lo in (False, True)
         for tb in (False, True) for c in (False, True)]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(k for k, v in c.items() if v)
                         or "plain")
@pytest.mark.parametrize("K", [8, 21, 64])
def test_plain_rows_mm_against_float64_products(case, K):
    N = K if case["lower"] else 13
    X, B, idx, C0, Xn, ops_b, C0n = _operands(0, 3, 5, K, N, **case)
    got = lref.rows_mm(X, B, idx, trans=case["trans"], lower=case["lower"],
                       C0=C0)
    want = np.stack([x @ b for x, b in zip(Xn, ops_b)])
    if C0n is not None:
        want = C0n - want
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _rel(got, want) < PLAIN_TOL
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(lops.rows_mm(X, B, idx, trans=case["trans"],
                                    lower=case["lower"], C0=C0), got)


@pytest.mark.parametrize("cinv", [False, True])
@pytest.mark.parametrize("s,b", [(12, 24), (33, 7), (64, 40)])
def test_plain_rows_reduce_against_float64_dots(cinv, s, b):
    rng = np.random.default_rng(1)
    nblk, u, nt = 3, 4, 5
    Phi, A, Z = (rng.normal(size=(nblk, u, s)) for _ in range(3))
    R, V = (rng.normal(size=(nblk, u, b)) for _ in range(2))
    alpha, Wy = rng.normal(size=s), rng.normal(size=(nt, b))
    kd = rng.normal(size=(nblk, u)) + 10.0
    idx = np.array([4, 0, 4])
    mean, var = lref.rows_reduce(*(_t(a) for a in (kd, Phi, alpha, R, Wy,
                                                   idx, A, V, Z)), cinv=cinv)
    w = Wy[idx][:, None, :]
    t2 = np.sum(R * V, -1) if cinv else np.sum(V * V, -1)
    assert _rel(mean, Phi @ alpha + np.sum(R * w, -1)) < PLAIN_TOL
    assert _rel(var, kd - np.sum(A * A, -1) - t2 + np.sum(Z * Z, -1)) \
        < PLAIN_TOL


def test_wrappers_take_meta_and_refuse_mixed_devices():
    X = torch.zeros((2, 3, 16), device="meta")
    B = torch.zeros((16, 16), device="meta")
    assert lops.rows_mm(X, B, trans=True, lower=True).shape == (2, 3, 16)
    with pytest.raises(ValueError, match="all lie on the CPU"):
        lops.rows_mm(torch.zeros((2, 3, 16)), B)


@pytest.mark.parametrize("u,qt", [(0, 1), (1, 1), (32, 1), (33, 2), (96, 3),
                                  (160, 5), (224, 4), (256, 4), (336, 6),
                                  (385, 5)])
def test_rows_plan_balances_the_query_tiles_of_a_block(u, qt):
    """A float32 kernel block takes the fewest blocks of at most 6 query
    tiles (32 rows each), balanced: 336 rows are 11 tiles in 2 blocks."""
    tiles = max(1, -(-u // lops.ROWS_QN))
    assert lops.rows_plan((3, u, 8), torch.zeros((8, 8))).qt == qt
    assert qt <= lops.ROWS_QT_MAX and -(-tiles // qt) == -(-tiles
                                                          // lops.ROWS_QT_MAX)


def test_rows_plan_stages_the_serving_tables_sixteen_bytes_at_a_time():
    """The tables as the plan keeps them go in by 16-byte copies: Q (M, s,
    b) row-major along its output columns, its column-major copy and K_SD
    read transposed along k, C_L^-1 either way; strided slices, rows that
    are not whole 16 bytes and unaligned starts one element at a time."""
    M, s, b = 3, 64, 48
    Q = torch.zeros((M, s, b))
    CL = torch.zeros((M, b, b))
    def plan(B, trans=False):
        return lops.rows_plan((M, 32, 64), B, trans).layout
    assert plan(Q) == lops.ROWS_NMAJ                         # R = A Q
    assert plan(Q.mT.contiguous().mT) == lops.ROWS_KMAJ
    assert plan(Q, trans=True) == lops.ROWS_KMAJ             # W K_SD^T
    assert plan(CL, trans=True) == lops.ROWS_KMAJ            # V = R C_L^-T
    assert plan(CL) == lops.ROWS_NMAJ                        # W = V C_L^-1
    assert plan(torch.zeros((M, s, 2 * b))[..., ::2]) == lops.ROWS_ANY
    assert plan(torch.zeros((M, 70, 71))) == lops.ROWS_ANY
    assert plan(torch.zeros((M, 70, 71)).mT) == lops.ROWS_ANY
    assert plan(torch.zeros((M * s * b + 1,))[1:].view(M, s, b)) \
        == lops.ROWS_ANY
    assert plan(torch.zeros((s, b))) == lops.ROWS_NMAJ


def test_rows_plan_numbers_triangular_panels_by_rank_where_queries_fit():
    """Under ``lower`` the blocks go by panel rank first (the longest
    panels of all table blocks first) where all blocks' queries fit in
    ROWS_PANEL_MAJOR_BYTES: the 256-row request's 20 blocks of 32 rows,
    not the 3200-row request's 336; never without ``lower``."""
    L = torch.zeros((64, 64))
    assert lops.rows_plan((20, 32, 2048), L, True, True).panel_major
    assert lops.rows_plan((20, 32, 1600), L, False, True).panel_major
    assert not lops.rows_plan((20, 336, 2048), L, True, True).panel_major
    assert not lops.rows_plan((20, 32, 2048), L, True, False).panel_major


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [dict(trans=True, lower=True, table=False,
                                       c0=False),
                                  dict(trans=False, lower=False, table=True,
                                       c0=True)],
                         ids=["shared-lower", "table-c0"])
def test_a_row_is_the_same_alone_at_another_slot_and_in_a_larger_batch(
        dtype, case):
    K = 40
    X, B, idx, C0, *_ = _operands(2, 4, 9, K, K, **case)
    X, B = X.to(dtype), B.to(dtype)
    C0 = None if C0 is None else C0.to(dtype)
    kw = dict(trans=case["trans"], lower=case["lower"])
    whole = lops.rows_mm(X, B, idx, C0=C0, **kw)
    k, r = 2, 5                                   # block 2, row 5
    ik = None if idx is None else idx[k:k + 1]
    alone = lops.rows_mm(X[k:k + 1, r:r + 1], B, ik,
                         C0=None if C0 is None else C0[k:k + 1, r:r + 1],
                         **kw)
    assert torch.equal(alone[0, 0], whole[k, r])
    # at slot 0 of a batch of 7 other rows, and in a batch of 12 blocks
    perm = torch.tensor([r, 0, 1, 2, 3, 4, 6, 7])
    moved = lops.rows_mm(X[k:k + 1, perm], B, ik,
                         C0=None if C0 is None else C0[k:k + 1, perm], **kw)
    assert torch.equal(moved[0, 0], whole[k, r])
    big = torch.cat([X, X.flip(0), X])
    ib = None if idx is None else torch.cat([idx, idx.flip(0), idx])
    cb = None if C0 is None else torch.cat([C0, C0.flip(0), C0])
    assert torch.equal(lops.rows_mm(big, B, ib, C0=cb, **kw)[8 + k], whole[k])

    s, b = 24, 10
    rng = np.random.default_rng(3)
    Phi, A, Z = (_t(rng.normal(size=(4, 9, s)), dtype) for _ in range(3))
    R, V = (_t(rng.normal(size=(4, 9, b)), dtype) for _ in range(2))
    alpha, Wy = _t(rng.normal(size=s), dtype), _t(rng.normal(size=(6, b)),
                                                  dtype)
    kd, ix = _t(rng.normal(size=(4, 9)), dtype), torch.tensor([5, 1, 0, 3])
    m, v = lops.rows_reduce(kd, Phi, alpha, R, Wy, ix, A, V, Z)
    one = lambda t: t[k:k + 1, r:r + 1]
    m1, v1 = lops.rows_reduce(one(kd), one(Phi), alpha, one(R), Wy,
                              ix[k:k + 1], one(A), one(V), one(Z))
    assert torch.equal(m1[0, 0], m[k, r]) and torch.equal(v1[0, 0], v[k, r])


# ---------------------------------------------------------------------------
# The routed program through the row products.
# ---------------------------------------------------------------------------

def _problem(dtype, seed=0):
    """tests/helpers.make_problem's shapes (n=96, |S|=12, d=3, M=4), 40
    queries, drawn with numpy; the JAX package fits, the port serves the
    carried state."""
    rng = np.random.default_rng(seed)
    n, u, s, d, M = 96, 40, 12, 3, 4
    X, S, U = (rng.normal(size=(k, d)).astype(dtype) for k in (n, s, u))
    y = (np.sin(X[:, 0]) * 2.0 + X[:, 1] - 0.5 * X[:, 2] ** 2
         + 0.3 * rng.normal(size=n)).astype(dtype)
    jparams = jcov.init_params(d, signal=1.3, noise=0.3, lengthscale=1.5,
                               dtype=jnp.dtype(dtype))
    jkfn = jcov.make_kernel("se")
    jmodel = japi.fit("ppic", jkfn, jparams, jnp.asarray(X), jnp.asarray(y),
                      S=jnp.asarray(S), runner=JVmapRunner(M=M))
    return dict(U=U, M=M, jkfn=jkfn, jparams=jparams, jstate=jmodel.state,
                kfn=cov.make_kernel("se"),
                params=convert.params_from_arrays(jparams, device="cpu"),
                state=convert.state_from_arrays(jmodel.state, device="cpu"))


@pytest.fixture(scope="module")
def prob():
    return _problem(np.float64)


@pytest.fixture(scope="module")
def prob32():
    return _problem(np.float32)


def _skewed(p, target, n, seed):
    c = np.asarray(p["state"].centroids[target])
    rng = np.random.RandomState(seed)
    return (c[None, :] + 0.01 * rng.randn(n, 3)).astype(p["U"].dtype)


@pytest.mark.parametrize("which", ["spread", "skewed"])
def test_routed_program_matches_reference_float64(prob, which):
    U = prob["U"] if which == "spread" else _skewed(prob, 1, 30, 0)
    m, v = ppic.predict_routed_diag(prob["kfn"], prob["params"],
                                    prob["state"], _t(U))
    jm, jv = jppic.predict_routed_diag(prob["jkfn"], prob["jparams"],
                                       prob["jstate"], jnp.asarray(U))
    assert float(np.abs(m.numpy() - np.asarray(jm)).max()) < STATE_TOL
    assert float(np.abs(v.numpy() - np.asarray(jv)).max()) < STATE_TOL
    assert bool((v > 0).all())


@pytest.mark.parametrize("name", ["prob", "prob32"])
@pytest.mark.parametrize("target", range(4))
def test_layouts_are_bitwise_equal(request, name, target):
    p = request.getfixturevalue(name)
    U = np.concatenate([_skewed(p, target, 24, target), p["U"][:12]])
    args = (p["kfn"], p["params"], p["state"], _t(U))
    lay = runner.scatter_two_bucket(_t(U), ppic.route_queries(
        p["state"], _t(U)), p["M"])
    assert lay.Xo is not None                        # groups exercised
    m_c, v_c = ppic.predict_routed_diag_capacity(*args)
    m_t, v_t = ppic.predict_routed_diag(*args)
    assert torch.equal(m_t, m_c) and torch.equal(v_t, v_c)


def test_plan_builds_its_tables_once_per_state_and_on_rebind(prob32):
    p = prob32
    st = p["state"]
    plan = api.get("ppic").plan(p["kfn"], p["params"], st,
                                api.ServeSpec(max_batch=16, routed=True))
    c = plan.caches
    assert c.Cinv is None and c.CLinv.shape == (4, 24, 24)
    eye = torch.eye(24).expand(4, 24, 24)
    assert torch.equal(c.CLinv, torch.tril(c.CLinv))
    assert float((c.CLinv @ st.C_L - eye).abs().max()) < 1e-4
    plan.routed_diag(_t(p["U"][:16]))
    plan.routed_diag(_t(p["U"][16:]))
    assert plan.caches is c and plan.caches.CLinv is c.CLinv
    st2 = st._replace(C_L=2.0 * st.C_L)
    c2 = plan.rebind(st2).caches
    assert c2.CLinv is not c.CLinv
    assert torch.equal(c2.CLinv, ppic.chol_inv_blocks(st2.C_L))


def test_overflow_groups_read_the_tables_in_place(prob32, monkeypatch):
    """A skewed request's overflow groups run in one batch with the main
    bucket, and every per-block table reaches the row products as the
    plan's or the state's own tensor, indexed: nothing of the owner block's
    factors is copied."""
    p = prob32
    plan = api.get("ppic").plan(p["kfn"], p["params"], p["state"],
                                api.ServeSpec(max_batch=32, routed=True))
    c, st = plan.caches, p["state"]
    own = {id(t) for t in (c.Q, c.CLinv, st.Ksd, st.Wy,
                           rbf_ops.tri_inv(st.Kss_L),
                           rbf_ops.tri_inv(st.Sdd_L))}
    seen = []
    mm, red = lops.rows_mm, lops.rows_reduce

    def rows_mm(X, B, idx=None, **kw):
        seen.append((X.shape[0], B, idx))
        return mm(X, B, idx, **kw)

    def rows_reduce(kd, Phi, alpha, R, Wy, idx, *rest, **kw):
        seen.append((Phi.shape[0], Wy, idx))
        return red(kd, Phi, alpha, R, Wy, idx, *rest, **kw)

    monkeypatch.setattr(lops, "rows_mm", rows_mm)
    monkeypatch.setattr(lops, "rows_reduce", rows_reduce)
    m, v = plan.routed_diag(_skewed(p, 2, 30, 5))
    g = plan.stats.last_g
    assert g > 0
    assert len(seen) == 7                  # A, R, V, W, Phi, Z; the reduce
    for nblk, table, idx in seen:
        assert nblk == p["M"] + g and id(table) in own
        assert idx is None or (idx.shape == (p["M"] + g,)
                               and bool((idx[p["M"]:] == 2).all()))
    assert bool(torch.isfinite(m).all() and (v > 0).all())


def test_cached_cinv_takes_the_same_kernels(prob32, monkeypatch):
    p = prob32
    plan = api.get("ppic").plan(p["kfn"], p["params"], p["state"],
                                api.ServeSpec(max_batch=16, routed=True,
                                              cached_cinv=True))
    assert plan.caches.CLinv is None
    calls = []
    mm = lops.rows_mm
    monkeypatch.setattr(lops, "rows_mm", lambda X, B, idx=None, **kw:
                        calls.append(B) or mm(X, B, idx, **kw))
    plan.routed_diag(_t(p["U"][:16]))
    assert len(calls) == 5 and any(B is plan.caches.Cinv for B in calls)
