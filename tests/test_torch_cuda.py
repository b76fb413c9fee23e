"""The port's CUDA kernels (rbf, xcov_diag, flash attention, SSD, the
Cholesky downdate, the row products of pPIC's routed diag) against their
plain versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
with that reason elsewhere; run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks at the main path's full shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import ops as attn_ops, ref as attn_ref
from repro_torch.kernels.rbf import ops, ref
from repro_torch.kernels.ssd import ops as ssd_ops, ref as ssd_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _factors(s, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    A1, A2 = rng.normal(size=(s, s)), rng.normal(size=(s, s))
    L1 = np.linalg.cholesky(A1 @ A1.T + s * np.eye(s))
    L2 = np.linalg.cholesky(A2 @ A2.T + 2 * s * np.eye(s))
    return tuple(torch.tensor(a).to(device=device, dtype=dtype)
                 for a in (L1, L2, rng.normal(size=(s,))))


@pytest.mark.parametrize("sq,sk", [((64, 3), (96, 3)), ((200, 21), (130, 21)),
                                   ((33, 7), (17, 7)), ((8, 1), (300, 1)),
                                   ((12, 5), (4, 9, 5)),
                                   ((4, 9, 5), (4, 9, 5))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2),
                                       (torch.float64, 1e-5)])
def test_rbf_kernel_matches_plain(cuda, sq, sk, dtype, tol):
    rng = np.random.default_rng(0)
    Xq = torch.tensor(rng.normal(size=sq)).to(cuda, dtype)
    Xk = torch.tensor(rng.normal(size=sk)).to(cuda, dtype)
    before = ops.rbf_launches
    got = ops.rbf_covariance(Xq, Xk, 1.7)
    torch.cuda.synchronize()
    assert ops.rbf_launches == before + 1
    want = ref.rbf_covariance(Xq, Xk, 1.7)
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.double() - want.double()).abs().max()) < tol


@pytest.mark.parametrize("sq,sk", [((2048, 5), (1601, 5)),
                                   ((70, 5), (3, 1601, 5)),
                                   ((2048, 5), (1604, 5)),
                                   ((3, 65, 5), (3, 130, 5))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2),
                                       (torch.float64, 1e-5)])
def test_rbf_kernel_vector_and_scalar_stores(cuda, sq, sk, dtype, tol):
    """Rows of m % 4 != 0 columns (not 16-byte aligned) store element by
    element, aligned ones four at a time; both give the plain values."""
    rng = np.random.default_rng(11)
    Xq = torch.tensor(rng.uniform(-1.7, 1.7, size=sq)).to(cuda, dtype)
    Xk = torch.tensor(rng.uniform(-1.7, 1.7, size=sk)).to(cuda, dtype)
    got = ops.rbf_covariance(Xq, Xk, torch.tensor(1.3, device=cuda))
    want = ref.rbf_covariance(Xq, Xk, 1.3)
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.double() - want.double()).abs().max()) < tol


@pytest.mark.parametrize("sq,sk", [((1, 5), (20, 1600, 5)), ((1, 3), (300, 3)),
                                   ((33, 7), (17, 7)), ((4, 9, 5), (4, 9, 5))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
def test_rbf_exact_kernel_matches_plain(cuda, sq, sk, dtype, tol):
    """rbf.cu's exact instance (the collective ICF loop's pivot column),
    computed in the inputs' dtype: within a few units of the last place of
    its plain version, and one count a launch."""
    rng = np.random.default_rng(5)
    Xq = torch.tensor(rng.uniform(-1.7, 1.7, size=sq)).to(cuda, dtype)
    Xk = torch.tensor(rng.uniform(-1.7, 1.7, size=sk)).to(cuda, dtype)
    before = ops.rbf_exact_launches
    got = ops.rbf_covariance_exact(Xq, Xk, torch.tensor(1.3, dtype=dtype,
                                                        device=cuda))
    torch.cuda.synchronize()
    assert ops.rbf_exact_launches == before + 1
    want = ref.rbf_covariance_exact(Xq, Xk, 1.3)
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.double() - want.double()).abs().max()) < tol


@pytest.mark.parametrize("n", [1, 8, 16, 33, 256])
@pytest.mark.parametrize("s,d", [(12, 3), (130, 21)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
def test_xcov_kernel_matches_plain(cuda, n, s, d, dtype, tol):
    rng = np.random.default_rng(n * s)
    Xq = torch.tensor(rng.normal(size=(n, d))).to(cuda, dtype)
    Xk = torch.tensor(rng.normal(size=(s, d))).to(cuda, dtype)
    L1, L2, alpha = _factors(s, dtype, cuda)
    for L2_ in (L2, None):
        before = ops.xcov_launches
        got = ops.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2_)
        torch.cuda.synchronize()
        assert ops.xcov_launches == before + 1
        want = ref.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2_)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol


def test_kernelspec_routes_cuda_tensors_through_the_kernels(cuda):
    from repro_torch.core import api, covariance as cov
    from repro_torch.parallel.runner import VmapRunner
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.normal(size=(96, 3)))
    y = torch.tensor(rng.normal(size=(96,)))
    S = torch.tensor(rng.normal(size=(12, 3)))
    U = torch.tensor(rng.normal(size=(24, 3)))
    params = cov.init_params(3, signal=1.3, noise=0.3, lengthscale=1.5,
                             dtype=torch.float64, device=cuda)
    spec = cov.make_spec("se")
    ops.reset_counts()
    model = api.fit("ppitc", spec, params, X, y, S=S, runner=VmapRunner(M=4),
                    device=cuda)
    mean, var = model.plan(api.ServeSpec(max_batch=16)).diag(U)
    assert ops.rbf_launches > 0 and ops.xcov_launches > 0
    plain = api.fit("ppitc", cov.make_spec("se", impl="torch"), params, X, y,
                    S=S, runner=VmapRunner(M=4), device=cuda)
    m_p, v_p = plain.predict_diag(U)
    # the covariance kernel accumulates in float32 (its contract)
    assert float((mean - m_p).abs().max()) < 1e-4
    assert float((var - v_p).abs().max()) < 1e-4


def test_xcov_query_tiles_agree(cuda):
    """The query tiles change the grid, not the numbers: float64's 8-, 16-
    and 32-row tiles agree to rounding, and float32's 8- to 64-row tiles
    (queries on the mma's N side, the same k chunks) to the bit."""
    rng = np.random.default_rng(5)
    for dtype, tiles in ((torch.float64, (32, 8, 16)),
                         (torch.float32, (64, 8, 16, 32))):
        Xq = torch.tensor(rng.normal(size=(64, 5))).to(cuda, dtype)
        Xk = torch.tensor(rng.normal(size=(40, 5))).to(cuda, dtype)
        L1, L2, alpha = _factors(40, dtype, cuda)
        want = ops.xcov_diag(Xq, Xk, L1, alpha, 0.9, L2, block_q=tiles[0])
        for bq in tiles[1:]:
            got = ops.xcov_diag(Xq, Xk, L1, alpha, 0.9, L2, block_q=bq)
            for g, w in zip(got, want):
                if dtype == torch.float64:
                    assert float((g - w).abs().max()) < 1e-12
                else:
                    assert torch.equal(g, w)


# float32 at the serving support size: the 1e-4 of chip_smoke.py's
# TOL_XCOV_F32_S2048 (the kernel multiplies by explicit inverses in 3xTF32
# where the plain version solves in float32, 2048 products an entry)
XCOV_S2048_N = [1, 8, 257, 3328]


@pytest.mark.parametrize("n", XCOV_S2048_N)
def test_xcov_f32_at_s2048_takes_the_tensor_cores(cuda, n):
    rng = np.random.default_rng(n)
    Xq = torch.tensor(rng.uniform(-1.7, 1.7, size=(n, 5))).to(cuda,
                                                               torch.float32)
    Xk = torch.tensor(rng.uniform(-1.7, 1.7, size=(2048, 5))).to(
        cuda, torch.float32)
    L1, L2, alpha = _factors(2048, torch.float32, cuda)
    for L2_ in (L2, None):
        before = ops.xcov_tc_launches
        got = ops.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2_)
        torch.cuda.synchronize()
        assert ops.xcov_tc_launches == before + 1
        want = ref.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2_)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-4


@pytest.mark.parametrize("n,s", [(8, 2048), (256, 2048), (3328, 2048),
                                 (9, 2049), (257, 100)])
def test_xcov_kernel_repeats_bitwise(cuda, n, s):
    """No float atomics: split panels add their chunks in a fixed order."""
    rng = np.random.default_rng(s + n)
    Xq = torch.tensor(rng.normal(size=(n, 5))).to(cuda, torch.float32)
    Xk = torch.tensor(rng.normal(size=(s, 5))).to(cuda, torch.float32)
    L1, L2, alpha = _factors(s, torch.float32, cuda)
    runs = [ops.xcov_diag(Xq, Xk, L1, alpha, 1.3, L2) for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def _fitted_ppitc(cuda, n_train, M, s_size):
    """pPITC fitted in float32 on the card (AIMPEAK-like, seed 0; support by
    select_support), the float64 evaluation of the same state, and test
    queries: conditioned factors (cond Sdd ~1e8 at s_size 2048)."""
    from repro_torch.core import api, covariance as cov, support
    from repro_torch.data import synthetic
    from repro_torch.parallel.runner import VmapRunner
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=n_train, n_test=512, seed=0, device=cuda))
    spec = cov.make_spec("se")
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             device=cuda)
    S = support.select_support(spec, params, ds.X[:8 * s_size], s_size)
    model = api.fit("ppitc", spec, params, ds.X, ds.y, S=S,
                    runner=VmapRunner(M=M), device=cuda)
    return model, ds.X_test


def test_xcov_conditioned_state_needs_3xtf32(cuda):
    """On a fitted state (cond Sdd ~1e8) the kernel stays within 1e-4 of
    the plain float32 version, and the same products with TF32-truncated
    operands (one TF32 product, emulated in float64) would not."""
    from repro_torch.core import covariance as cov
    model, U = _fitted_ppitc(cuda, 16384, 8, 2048)
    p, st = model.params, model.state
    args = (cov._scale(p, U), cov._scale(p, st.S), st.Kss_L, st.alpha,
            cov.signal_var(p), st.Sdd_L)
    got = ops.xcov_diag(*args)
    want = ref.xcov_diag(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err <= 1e-4

    def trunc(x):
        return (x.view(torch.int32) & ~0x1fff).view(torch.float32).double()
    Uq, Sk = args[0], args[1]
    q2 = (Uq * Uq).sum(1)[:, None]
    k2 = (Sk * Sk).sum(1)[None]
    K = args[4] * torch.exp(-0.5 * torch.clamp(q2 + k2 - 2 * Uq @ Sk.T,
                                               min=0))
    v1 = trunc(K) @ trunc(ops.tri_inv(st.Kss_L)).T
    v2 = trunc(K) @ trunc(ops.tri_inv(st.Sdd_L)).T
    var1 = float(args[4]) - (v1 * v1).sum(1) + (v2 * v2).sum(1)
    assert float((var1 - want[1].double()).abs().max()) > 1e-4


def test_plan_diag_caches_the_inverses(cuda):
    """plan.diag with the cached inverses equals the path that builds them
    on every dispatch, bit for bit, and builds none after the first; a
    rebind onto a perturbed state refreshes them."""
    from repro_torch.core import api, covariance as cov
    model, U = _fitted_ppitc(cuda, 4096, 4, 256)
    plan = model.plan(api.ServeSpec(max_batch=256)).warmup(5)
    ops.reset_counts()
    cached = [plan.diag(U[:n]) for n in (8, 200, 512)]
    assert ops.inverse_builds == 0 and ops.xcov_tc_launches == 3
    for n, (m, v) in zip((8, 200, 512), cached):
        ops._INVERSES.clear()
        m2, v2 = plan.diag(U[:n])
        assert torch.equal(m, m2) and torch.equal(v, v2)
    assert ops.inverse_builds == 6
    st = model.state
    bumped = api.PITCState(st.S, st.Kss_L.clone(), st.Sdd_L * 1.05,
                           st.alpha * 0.9)
    moved = plan.rebind(bumped)
    m_f, v_f = moved.diag(U)
    compose = model.method.plan(cov.make_spec("se", fused=False),
                                model.params, bumped)
    m_c, v_c = compose.diag(U)
    assert float((m_f - m_c).abs().max()) < 1e-4
    assert float((v_f - v_c).abs().max()) < 1e-4
    m_0, v_0 = plan.diag(U)
    assert float((m_f - m_0).abs().max()) > 1e-2
    assert float((v_f - v_0).abs().max()) > 1e-3


def test_xcov_kernel_rejects_bfloat16(cuda):
    X = torch.zeros(4, 2, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.xcov_diag(X, X, torch.eye(4, device=cuda), torch.zeros(4,
                      device=cuda), 1.0)


# --- the ICF kernel (select_support's pivot loop) ----------------------------

# (n, R, d): select_support's shape on the GP main path, a ragged case, and
# 40 distinct points each present twice (exact ties: the first-max rule)
ICF_CASES = [(8192, 2048, 5), (1000, 120, 7), ("duplicates", 30, 3)]
ICF_SIG2 = 1.3
# float32: the plain loop replayed along the kernel's pivots must find each
# of them within this (x sig2) of its own largest residual. Both loops round
# each step's GEMV (i terms) in their own order, an error of ~sqrt(i) eps
# sig2 in f that the division by sqrt(d_p) amplifies and d accumulates:
# ~1e-5 sig2 late in a 2048-step run, so 1e-4 leaves 10x. Where the plain
# loop's two largest residuals are that close, the two may pick apart.
ICF_TIE_F32 = 1e-4
# float32 F against that replay, x sqrt(sig2) (F's largest entry): ~13x the
# largest reading on the H100 (2.9e-5 to 3.9e-5 sqrt(sig2) at (8192, 2048,
# 5), seeds 3-5; 2.9e-5 on the AIMPEAK candidates in chip_smoke.py). Late
# rows' entries are ~0.07 sqrt(sig2), so a wrong row or column errs by 100x
# this limit.
ICF_F32_TOL = 5e-4


def _icf_inputs(n, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    if n == "duplicates":
        P = rng.normal(size=(40, d))
        X = np.concatenate([P, P])
    else:
        X = rng.uniform(-2.0, 2.0, size=(n, d)) / 1.2
    return torch.tensor(X).to(device, dtype)


def icf_tolerance(F, piv, sig2):
    """Limits for the kernel's F and residual against the plain loop's
    (same pivots). Each f sums i <= R products of factor entries bounded by
    sig2 (|F[:, j]|^2 <= K_jj), rounded in another order than the plain
    loop's, then divides by sqrt(d_p): R eps sig2 / sqrt(min d_p), times 64
    for the errors earlier rows carry into later ones. The residual
    sig2 - sum_i f_ij^2 moves by at most 2 sqrt(R sig2) times that.
    min d_p = min_i F[i, p_i]^2, since f_p = sqrt(d_p)."""
    R = F.shape[0]
    eps = torch.finfo(F.dtype).eps
    min_dp = float(F[torch.arange(R, device=F.device), piv].pow(2).min())
    tol_f = 64 * R * eps * sig2 / max(min_dp, 1e-300) ** 0.5
    return tol_f, 2 * (R * sig2) ** 0.5 * tol_f, min_dp


@pytest.mark.parametrize("n,R,d", ICF_CASES)
def test_icf_kernel_matches_plain_f64(cuda, n, R, d):
    Xs = _icf_inputs(n, d, torch.float64, cuda)
    sig2 = torch.tensor(ICF_SIG2, dtype=torch.float64, device=cuda)
    before = ops.icf_launches
    F, piv, resid = ops.icf_factor(Xs, sig2, R)
    torch.cuda.synchronize()
    assert ops.icf_launches == before + 1
    Fw, pw, rw = ref.icf_factor(Xs, sig2, R)
    assert torch.equal(piv, pw)
    tol_f, tol_r, min_dp = icf_tolerance(Fw, pw, ICF_SIG2)
    err_f = float((F - Fw).abs().max())
    err_r = float((resid - rw).abs().max())
    print(f"ICF f64 n={n} R={R} d={d}: min d_p {min_dp:.3e}; max|dF| "
          f"{err_f:.3e} (tol {tol_f:.3e}), max|dresid| {err_r:.3e} (tol "
          f"{tol_r:.3e})")
    assert err_f <= tol_f and err_r <= tol_r


@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("n,R,d", ICF_CASES[:2])
def test_icf_kernel_f32_pivots_are_near_ties_of_the_plain_loop(cuda, n, R, d,
                                                               seed):
    """float32: the plain loop replayed along the kernel's pivots finds every
    one of them within ICF_TIE_F32 of its largest residual (so the two agree
    up to the first such near-tie), with the same factor within
    ICF_F32_TOL."""
    Xs = _icf_inputs(n, d, torch.float32, cuda, seed=seed)
    sig2 = torch.tensor(ICF_SIG2, device=cuda)
    F, piv, _ = ops.icf_factor(Xs, sig2, R)
    Fr, _, _ = ref.icf_factor(Xs, sig2, R, pivots=piv)
    slack = ref.icf_slack(Fr, piv, sig2)
    _, pw, _ = ref.icf_factor(Xs, sig2, R)
    differ = (piv != pw).nonzero()
    prefix = int(differ[0]) if differ.numel() else R
    tol_f = ICF_F32_TOL * ICF_SIG2 ** 0.5
    err_f = float((F - Fr).abs().max())
    print(f"ICF f32 n={n} R={R} seed {seed}: pivots agree with the plain "
          f"loop for {prefix} steps; max slack {float(slack.max()):.3e} (tol "
          f"{ICF_TIE_F32 * ICF_SIG2:.1e}); max|dF| {err_f:.3e} "
          f"({err_f / ICF_SIG2 ** 0.5:.2e} sqrt(sig2); tol {tol_f:.1e})")
    assert float(slack.max()) <= ICF_TIE_F32 * ICF_SIG2
    assert err_f <= tol_f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_icf_kernel_repeats_bitwise_and_cache_changes_nothing(cuda, dtype):
    """No atomics: three launches are bitwise equal, and keeping fewer
    factor rows on chip (none in registers: cached_rows=smem_rows; none at
    all: cached_rows=0) gives the same bits, since the on-chip and the
    global entries are the same numbers summed in the same order."""
    Xs = _icf_inputs(8192, 5, dtype, cuda)
    sig2 = torch.tensor(ICF_SIG2, dtype=dtype, device=cuda)
    plan = ops.icf_plan(dtype, 8192, 2048, 5)
    assert plan["blocks"] * plan["width"] >= 8192
    assert 0 < plan["cached_rows"] < 2048
    runs = [ops.icf_factor(Xs, sig2, 2048) for _ in range(3)]
    runs.append(ops.icf_factor(Xs, sig2, 2048,
                               cached_rows=plan["smem_rows"]))
    runs.append(ops.icf_factor(Xs, sig2, 2048, cached_rows=0))
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def test_icf_kernel_rejects_what_it_cannot_run(cuda):
    X = torch.zeros(16, 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.icf_factor(X, 1.0, 4)
    limit = ops.icf_plan(torch.float64, 16, 4, 3)["max_rank"]
    with pytest.raises(ValueError, match=f"limit of {limit} pivots"):
        ops.icf_factor(X.double(), 1.0, limit + 1)


def test_select_support_runs_one_icf_launch(cuda):
    """select_support with an SE spec on the card: one ICF launch, no rbf
    launch, and the support the plain loop selects (float64)."""
    from repro_torch.core import covariance as cov, support
    rng = np.random.default_rng(7)
    C = torch.tensor(rng.uniform(-2.0, 2.0, size=(1000, 5)), device=cuda)
    params = cov.init_params(5, signal=1.3, noise=0.3, lengthscale=1.2,
                             dtype=torch.float64, device=cuda)
    ops.reset_counts()
    S = support.select_support(cov.make_spec("se"), params, C, 100)
    torch.cuda.synchronize()
    assert (ops.icf_launches, ops.rbf_launches) == (1, 0)
    _, piv, _ = ref.icf_factor(cov._scale(params, C), cov.signal_var(params),
                               100)
    assert torch.equal(S, C.index_select(0, piv))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_icf_kernel_ragged_warp_columns_and_pivot_values(cuda, dtype):
    """n = 32000 (pICF's |D|) at R = 256: 130 blocks of 248 columns, 31 a
    warp, so each warp's last group of NC = 8 holds 7 (W / 8 not a multiple
    of NC). float64: pivots equal the plain loop's, F, the residual and the
    pivot values d_p within icf_tolerance; float32: the same pivot values
    along its own pivots as the plain loop replayed on them."""
    n, R, d = 32000, 256, 5
    plan = ops.icf_plan(dtype, n, R, d)
    assert plan["width"] % 64 != 0 and plan["width"] // 8 % 8 != 0
    Xs = _icf_inputs(n, d, dtype, cuda, seed=6)
    sig2 = torch.tensor(ICF_SIG2, dtype=dtype, device=cuda)
    F, piv, resid, dp = ops.icf_factor(Xs, sig2, R, pivot_values=True)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        Fw, pw, rw, dw = ref.icf_factor(Xs, sig2, R, pivot_values=True)
        assert torch.equal(piv, pw)
        tol_f, tol_r, _ = icf_tolerance(Fw, pw, ICF_SIG2)
        assert float((F - Fw).abs().max()) <= tol_f
        assert float((resid - rw).abs().max()) <= tol_r
        assert float((dp - dw).abs().max()) <= tol_r
    else:
        Fr, _, _, dr = ref.icf_factor(Xs, sig2, R, piv, pivot_values=True)
        assert float((F - Fr).abs().max()) <= ICF_F32_TOL * ICF_SIG2 ** 0.5
        assert float((dp - dr).abs().max()) <= ICF_F32_TOL * ICF_SIG2
    # d_p is each step's pivot entry squared, f_p = sqrt(d_p), to rounding
    fpp = F[torch.arange(R, device=cuda), piv]
    assert float((fpp.pow(2) - dp).abs().max()) <= 1e-3 * ICF_SIG2


def test_picf_plan_on_the_card_matches_the_plain_path(cuda):
    """pICF fitted and served through the kernels (one ICF launch, rbf for
    K_{U,D_m}) against the plain path (impl="torch": the plain loop and
    covariance) in float64: same pivots, state and served output within
    limits set by rbf's float32 accumulation (K_UD's entries err by
    ~1e-7 of sig2, which eqs. 24-27 amplify by |D| / s2 ~ 1e4)."""
    from repro_torch.core import api, covariance as cov
    from repro_torch.parallel.runner import VmapRunner
    rng = np.random.default_rng(8)
    X = torch.tensor(rng.uniform(-2, 2, size=(2048, 5)), device=cuda)
    y = torch.sin(2 * X[:, 0]) + X[:, 1] * torch.cos(X[:, 2])
    U = torch.tensor(rng.uniform(-2, 2, size=(300, 5)), device=cuda)
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             dtype=torch.float64, device=cuda)
    ops.reset_counts()
    k = api.fit("picf", cov.make_spec("se"), params, X, y, rank=256,
                runner=VmapRunner(M=8), device=cuda)
    assert ops.icf_launches == 1
    p = api.fit("picf", cov.make_spec("se", impl="torch"), params, X, y,
                rank=256, runner=VmapRunner(M=8), device=cuda)
    assert ops.icf_launches == 1
    for f in ("F", "Phi_L", "ydd"):
        a, b = getattr(k.state, f), getattr(p.state, f)
        assert float((a - b).abs().max()) <= 1e-8 * float(b.abs().max()), f
    mk, vk = k.plan(api.ServeSpec(max_batch=256)).diag(U)
    assert ops.rbf_launches >= 1          # K_{U,D_m}, all machines at once
    mp, vp = p.plan(api.ServeSpec(max_batch=256)).diag(U)
    scale = 1.0 + float(torch.cat([mp, vp]).abs().max())
    assert float((mk - mp).abs().max()) <= 1e-2 * scale
    assert float((vk - vp).abs().max()) <= 1e-2 * scale
    assert bool(torch.isfinite(mk).all() and torch.isfinite(vk).all())


@pytest.mark.parametrize("call", ["rbf", "icf", "xcov", "downdate",
                                  "rows_mm", "rows_reduce"])
def test_kernel_wrappers_refuse_a_graph(cuda, call):
    """Asked for a gradient, each CUDA wrapper without a backward kernel
    raises (it would return a tensor cut from the graph); under no_grad, or
    with no input requiring grad, it launches. (Flash and SSD have backward
    kernels: ``test_flash_and_ssd_wrappers_record_a_graph``.)"""
    from repro_torch.kernels.linalg import ops as linalg_ops
    X = torch.randn(64, 3, device=cuda, dtype=torch.float64)
    s2 = torch.tensor(1.3, device=cuda, dtype=torch.float64,
                      requires_grad=True)
    L1, _, alpha = _factors(16, torch.float64, cuda)
    # the downdate wrapper takes no scalar: the graph comes in through a
    # second tensor input instead
    W = torch.randn(16, 3, device=cuda, dtype=torch.float64) * 0.1
    W.requires_grad_(True)
    run = {"rbf": lambda x: ops.rbf_covariance(x, X[:16], s2),
           "icf": lambda x: ops.icf_factor(x, s2, 8),
           "xcov": lambda x: ops.xcov_diag(x, X[:16], L1, alpha, s2),
           "downdate": lambda x: linalg_ops.chol_downdate(L1, W),
           "rows_mm": lambda x: linalg_ops.rows_mm(W.mT[None], L1,
                                                    C0=W.mT[None]),
           "rows_reduce": lambda x: linalg_ops.rows_reduce(
               W[None, :, 0], W[None], alpha[:3], W[None], W[:1], None,
               W[None], W[None], W[None])}[call]
    with pytest.raises(RuntimeError, match="no backward"):
        run(X)
    with torch.no_grad():
        run(X)
    for t in (s2, W):
        t.requires_grad_(False)
    if call in ("rbf", "icf", "xcov"):
        with pytest.raises(RuntimeError, match="no backward"):
            run(X.clone().requires_grad_(True))
    run(X)


@pytest.mark.parametrize("call", ["flash", "ssd"])
def test_flash_and_ssd_wrappers_record_a_graph(cuda, call):
    """In grad mode, with an input that requires grad, the output has a
    ``grad_fn`` and ``backward`` launches the backward kernel once; under
    no_grad the forward alone runs and the output has none."""
    g = torch.Generator(device=cuda).manual_seed(7)
    if call == "flash":
        q = torch.randn((1, 2, 16, 64), generator=g, device=cuda,
                        dtype=torch.bfloat16).requires_grad_(True)
        run = lambda: attn_ops.attention(q, q.detach(), q.detach())
        mod, attr, leaf = attn_ops, "flash_bwd_launches", q
    else:
        dA = (-torch.rand((1, 2, 16), generator=g, device=cuda)
              ).requires_grad_(True)
        args = [torch.randn(s, generator=g, device=cuda)
                for s in ((1, 16, 2, 8), (1, 16, 8), (1, 16, 8))]
        run = lambda: ssd_ops.intra_chunk(args[0], dA, args[1], args[2])[0]
        mod, attr, leaf = ssd_ops, "ssd_bwd_launches", dA
    with torch.no_grad():
        assert run().grad_fn is None
    out = run()
    assert out.grad_fn is not None
    before = getattr(mod, attr)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert getattr(mod, attr) == before + 1
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    assert float(leaf.grad.float().abs().max()) > 0


# --- the Cholesky downdate (the streaming stores' retire) ----------------------

def _downdate_inputs(cuda, n, b, dtype, seed=0, zero_cols=()):
    """A lower factor L1 = chol(L0 L0ᵀ + W Wᵀ) (the QR of its root) and W:
    downdating L1 by W gives back L0, well conditioned."""
    from repro_torch.core import linalg
    rng = np.random.default_rng(seed)
    L0 = np.tril(rng.normal(size=(n, n)) * 0.1, -1) \
        + np.diag(1.0 + rng.random(n))
    W = rng.normal(size=(n, b)) * 0.5 / np.sqrt(max(b, 1))
    W[:, list(zero_cols)] = 0.0
    L0, W = (torch.tensor(a, dtype=dtype, device=cuda) for a in (L0, W))
    return L0, linalg.chol_from_root(L0, W), W


DOWNDATE_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b,zero_cols", [
    (64, 16, ()), (300, 257, ()), (128, 1, ()), (8, 40, ()),
    (1, 3, ()), (96, 12, (0, 5, 11))]
    + [(n, b, ()) for n in (31, 32, 33) for b in (7, 8, 9)]
    + [(63, 8, ()), (65, 8, ()), (64, 33, ())])
def test_downdate_kernel_matches_plain(cuda, n, b, zero_cols, dtype):
    """The kernel against its plain version (the reference's sweeps in
    wavefront order) on the same inputs, bit for bit: b = 1, b > n, n = 1,
    ragged tiles, n one less than, equal to and one more than the kernel's
    32-row and 32-column tiles (one and two of them), zero columns; and
    both give back the factor before the update. Each launch is counted
    once, and a repeat is bitwise equal."""
    from repro_torch.kernels.linalg import ops as linalg_ops, \
        ref as linalg_ref
    L0, L1, W = _downdate_inputs(cuda, n, b, dtype, zero_cols=zero_cols)
    linalg_ops.reset_counts()
    got = linalg_ops.chol_downdate(L1, W)
    again = linalg_ops.chol_downdate(L1, W)
    torch.cuda.synchronize()
    assert linalg_ops.chol_downdate_launches == 2
    want = linalg_ref.chol_downdate(L1, W)
    assert torch.equal(got, again)
    assert got.is_contiguous() and torch.equal(got.triu(1), L1.triu(1))
    tol = DOWNDATE_TOL[dtype]
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, want)
    assert float((got - L0).abs().max()) <= 100 * tol


def test_downdate_chain_probe_is_no_launch_of_the_kernel(cuda):
    """The serial-floor probe (diagonal and sub-diagonal items only) runs
    on the downdate's arguments, counts no launch and leaves its inputs."""
    from repro_torch.kernels.linalg import ops as linalg_ops
    _, L1, W = _downdate_inputs(cuda, 100, 20, torch.float64)
    L1c, Wc = L1.clone(), W.clone()
    linalg_ops.reset_counts()
    linalg_ops.chain_probe(L1, W)
    torch.cuda.synchronize()
    assert linalg_ops.chol_downdate_launches == 0
    assert torch.equal(L1, L1c) and torch.equal(W, Wc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_downdate_quotient_is_ieee_division(cuda, dtype):
    """The kernel's row-update quotient (its range check, then the
    branch-free quotient from y = 1/c or the IEEE division) through the
    probe library, on the hard operands of ``tests/test_torch_downdate.py``:
    each step takes the path its operands' range calls for (an operand just
    outside the range, in any slot or as c, sends it to the division; one
    in a slot that is no row does not), and every quotient of a row is the
    IEEE quotient bit for bit (a NaN as a NaN)."""
    from repro_torch.kernels.linalg import ops as linalg_ops
    from test_torch_downdate import quotient_groups
    fmt, bits = {torch.float32: (np.float32, np.int32),
                 torch.float64: (np.float64, np.int64)}[dtype]
    a, c, mask, fast = quotient_groups(fmt)
    q, took = linalg_ops.quotient_probe(
        *(torch.from_numpy(x).to(cuda) for x in (a, c, mask)))
    assert took.cpu().numpy().tolist() == fast.tolist()
    with np.errstate(all="ignore"):
        want = a / c[:, None]                    # IEEE division, numpy
    got = q.cpu().numpy()
    rows = (mask.view(np.uint32)[:, None]
            >> np.arange(32, dtype=np.uint32)) & 1 == 1
    same = (got.view(bits) == want.view(bits)) \
        | (np.isnan(got) & np.isnan(want))
    assert same[rows].all()


def test_downdate_kernel_zero_columns_and_empty(cuda):
    """Zero columns leave L as it is, bit for bit; b = 0 launches nothing."""
    from repro_torch.kernels.linalg import ops as linalg_ops
    L0, _, _ = _downdate_inputs(cuda, 200, 1, torch.float64)
    linalg_ops.reset_counts()
    Z = torch.zeros(200, 7, dtype=torch.float64, device=cuda)
    assert torch.equal(linalg_ops.chol_downdate(L0, Z), L0)
    assert torch.equal(linalg_ops.chol_downdate(L0, Z[:, :0]), L0)
    assert linalg_ops.chol_downdate_launches == 1


def test_downdate_kernel_rejects_what_it_cannot_run(cuda):
    from repro_torch.kernels.linalg import ops as linalg_ops
    L = torch.eye(8, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        linalg_ops.chol_downdate(L.half(), torch.zeros(8, 2, device=cuda)
                                 .half())
    with pytest.raises(ValueError, match="need L"):
        linalg_ops.chol_downdate(L, torch.zeros(7, 2, device=cuda))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        linalg_ops.chol_downdate(L, torch.zeros(8, 2))


def test_ppitc_store_retire_revive_on_the_card(cuda):
    """A float64 pPITC store on the card: retire takes one downdate launch
    and agrees with the same store on the CPU (plain sweeps) and with the
    refold of the survivors; revive comes back to the streamed state."""
    from repro_torch.core import api, covariance as cov, online
    from repro_torch.data import synthetic
    from repro_torch.kernels.linalg import ops as linalg_ops
    from repro_torch.parallel.runner import VmapRunner
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=4096, n_test=256, seed=0, device=cuda))
    X, y = ds.X.double(), ds.y.double()
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             dtype=torch.float64, device=cuda)
    S = X[:256]
    stores = {}
    for dev in (cuda, torch.device("cpu")):
        store = api.init_store(
            "ppitc", cov.make_spec("se", impl="torch"), params, X[:2048],
            y[:2048], S=S, runner=VmapRunner(M=4), device=dev)
        stores[dev.type] = store.assimilate(X[2048:], y[2048:])
    linalg_ops.reset_counts()
    dead = stores["cuda"].retire(3)
    torch.cuda.synchronize()
    assert linalg_ops.chol_downdate_launches == 1
    dead_cpu = stores["cpu"].retire(3)
    assert linalg_ops.chol_downdate_launches == 1

    def rel(a, b):
        a, b = a.cpu(), b.cpu()
        return float((a - b).abs().max() / (1 + b.abs().max()))

    for a, b in zip(dead.to_state(), dead_cpu.to_state()):
        assert rel(a, b) < 1e-9
    refold = online.with_alive(dead.store, dead.store.alive, mode="refold")
    assert rel(dead.store.Sdd_L, refold.Sdd_L) < 1e-9
    back = dead.revive(3).to_state()
    for a, b in zip(back, stores["cuda"].to_state()):
        assert rel(a, b) < 1e-9


def test_float32_store_retire_downdates_in_float64_on_the_card(cuda):
    """A float32 pPITC store on the card retires by one launch of the
    kernel's float64 instance and keeps its factor in float32: the plain
    sweeps in float64 on the same factor, rounded to float32, bit for
    bit."""
    from repro_torch.core import api, covariance as cov
    from repro_torch.data import synthetic
    from repro_torch.kernels.linalg import ops as linalg_ops, \
        ref as linalg_ref
    from repro_torch.parallel.runner import VmapRunner
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=4096, n_test=256, seed=0, device=cuda))
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             device=cuda)
    store = api.init_store("ppitc", cov.make_spec("se"), params, ds.X,
                           ds.y, S=ds.X[:256], runner=VmapRunner(M=4),
                           device=cuda)
    linalg_ops.reset_counts()
    dead = store.retire(3)
    torch.cuda.synchronize()
    assert linalg_ops.chol_downdate_launches == 1
    assert dead.store.Sdd_L.dtype == torch.float32
    want = linalg_ref.chol_downdate(store.store.Sdd_L.double(),
                                    store.store.F[3].double()).float()
    assert torch.equal(dead.store.Sdd_L, want)


# --- flash attention and SSD (the LM serving slice) ---------------------------

# the reference's tolerances: flash 2e-3 f32 / 3e-2 bf16
# (tests/test_kernels.py), SSD 3e-4 for Y and S, 1e-5 for cum
# (tests/test_ssd_kernel.py). The flash ones are absolute, and a row that
# sees n keys of random data has outputs of ~0.8 sqrt(e / n), so each case
# is also held row by row to a limit scaled to the output's size:
# max_d (|got - want| - r |want|)+ <= c rms_d(want), with r one bf16 ulp
# (2^-7) of the output in bf16 and c = 2e-2 for the kernel's bf16 rounding
# of P before P.V; r = 0 and c = 1e-4 in f32 (chip_smoke.py gives the
# numbers behind them). The reference set the SSD 3e-4 for outputs of up
# to ~10 whose cumsum both sides computed alike. Here the kernel's block
# scan and torch.cumsum round cum (~ -20 at cs = 256) differently by
# ~1e-6, which exp(cum_i - cum_j) carries into Y and S relative to their
# size, and those reach ~1e2 at cs = 256, N = 128: beyond 10 the tolerance
# grows with the output's size (3e-5 relative).
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
FLASH_ROW_TOL = {torch.float32: (0.0, 1e-4),
                 torch.bfloat16: (2.0 ** -7, 2e-2)}


def ssd_tol(want: torch.Tensor, base: float) -> float:
    return base * max(1.0, float(want.abs().max()) / 10.0)


def flash_row_err(got: torch.Tensor, want: torch.Tensor, r: float) -> float:
    """max over rows of max_d (|got - want| - r |want|)+ / rms_d(want); a
    row whose want is all zero (no valid key) must match exactly."""
    g, w = got.double(), want.double()
    excess = ((g - w).abs() - r * w.abs()).clamp(min=0).amax(-1)
    rms = w.pow(2).mean(-1).sqrt()
    return float((excess / rms.clamp(min=1e-300)).max())


FLASH_CASES = [(1, 4, 4, 128, 128, 64, None, 0),
               (2, 8, 2, 128, 128, 64, None, 0),
               (1, 4, 4, 256, 256, 32, 128, 0),
               (1, 2, 2, 64, 256, 64, None, 192),
               (1, 4, 2, 100, 200, 48, None, 100),
               (1, 1, 1, 64, 64, 128, 32, 0),
               (1, 2, 1, 70, 70, 16, None, 0),
               (1, 2, 2, 65, 65, 256, 40, 0),
               (2, 4, 2, 33, 33, 100, None, 0),      # D % 8 != 0
               (1, 2, 2, 9, 9, 1, None, 0),
               (2, 16, 8, 1, 300, 128, None, 211),   # decode step
               (2, 4, 1, 1, 96, 16, 16, 95),
               # the Hopper kernel's tile boundaries: 128 query rows, 128
               # keys (64 at D = 256), a 3-stage K/V ring (2 at D = 256)
               (1, 4, 2, 127, 127, 128, None, 0),
               (1, 4, 2, 128, 128, 128, None, 0),
               (1, 4, 2, 129, 129, 128, None, 0),
               (1, 4, 2, 257, 257, 128, None, 0),
               (1, 4, 2, 1000, 1000, 128, None, 0),
               (1, 64, 8, 200, 200, 128, None, 0),   # GQA 8:1
               (2, 4, 2, 300, 300, 256, 100, 0),     # D = 256, window
               (2, 16, 8, 1, 1024, 128, None, 700)]  # decode, 6 KV tiles


def _qkv(cuda, dtype, B, Hq, Hkv, Tq, Tk, D, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,off", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, Hq, Hkv, Tq, Tk, D, window, off,
                                    dtype):
    q, k, v = _qkv(cuda, dtype, B, Hq, Hkv, Tq, Tk, D)
    before = attn_ops.flash_launches
    before_sm90 = attn_ops.flash_sm90_launches
    # three launches: a stage released before its product completes would
    # show as a run that differs from the others
    runs = [attn_ops.attention(q, k, v, window=window, q_offset=off)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert attn_ops.flash_launches == before + 3
    assert attn_ops.flash_sm90_launches == \
        before_sm90 + 3 * (dtype == torch.bfloat16)
    got = runs[0]
    assert all(torch.equal(r, got) for r in runs[1:])
    want = attn_ref.attention(q, k, v, window=window, q_offset=off)
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]
    r, c = FLASH_ROW_TOL[dtype]
    assert flash_row_err(got, want, r) <= c


# non-causal (an encoder's self-attention, cross-attention): whisper's
# encoder, its cross prefill and decode step over 1500 frames, ragged GQA,
# and a single key
FLASH_NONCAUSAL_CASES = [(2, 16, 16, 1500, 1500, 64),
                         (1, 16, 16, 448, 1500, 64),
                         (4, 16, 16, 1, 1500, 64),
                         (1, 4, 2, 100, 200, 48),
                         (2, 4, 2, 16, 1, 64),
                         (1, 4, 2, 129, 257, 128)]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", FLASH_NONCAUSAL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_non_causal_matches_plain(cuda, B, Hq, Hkv, Tq, Tk, D,
                                               dtype):
    q, k, v = _qkv(cuda, dtype, B, Hq, Hkv, Tq, Tk, D, seed=4)
    attn_ops.reset_counts()
    runs = [attn_ops.attention(q, k, v, causal=False) for _ in range(3)]
    torch.cuda.synchronize()
    assert attn_ops.flash_launches == attn_ops.flash_noncausal_launches == 3
    assert attn_ops.flash_sm90_launches == 3 * (dtype == torch.bfloat16)
    got = runs[0]
    assert all(torch.equal(r, got) for r in runs[1:])
    want = attn_ref.attention(q, k, v, causal=False)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]
    r, c = FLASH_ROW_TOL[dtype]
    assert flash_row_err(got, want, r) <= c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_strided_views(cuda, dtype):
    """q/k/v as (B, T, H, D) buffers seen as (B, H, T, D), the layout the
    projections leave them in."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(cuda, dtype, 2, 8, 4, 80, 80, 64, seed=1))
    assert not q.is_contiguous()
    before_sm90 = attn_ops.flash_sm90_launches
    got = attn_ops.attention(q, k, v)
    torch.cuda.synchronize()
    assert attn_ops.flash_sm90_launches == \
        before_sm90 + (dtype == torch.bfloat16)   # read in place, no pad
    assert got.stride() == q.stride()
    want = attn_ops.attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_flash_kernel_pads_what_tma_cannot_address(cuda):
    """A slice 8 bytes past a 16-byte boundary takes the padded copy, then
    the same Hopper kernel."""
    q, k, v = _qkv(cuda, torch.bfloat16, 2, 8, 4, 150, 150, 72, seed=2)
    q = q[..., 4:68]
    k, v = k[..., :64].contiguous(), v[..., :64].contiguous()
    assert attn_ops.route(q, k, v) == "pad"
    before_sm90 = attn_ops.flash_sm90_launches
    got = attn_ops.attention(q, k, v)
    torch.cuda.synchronize()
    assert attn_ops.flash_sm90_launches == before_sm90 + 1
    want = attn_ref.attention(q, k, v)
    r, c = FLASH_ROW_TOL[torch.bfloat16]
    assert float((got.float() - want.float()).abs().max()) < \
        FLASH_TOL[torch.bfloat16]
    assert flash_row_err(got, want, r) <= c


def test_flash_kernel_rows_without_a_key_are_zero(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 2, 2, 4, 8, 64)
    out = attn_ops.attention(q, k, v, causal=True, window=2, q_offset=20)
    assert torch.equal(out, torch.zeros_like(out))


def test_flash_kernel_rejects_float16(cuda):
    q, k, v = _qkv(cuda, torch.float16, 1, 2, 2, 8, 8, 16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        attn_ops.attention(q, k, v)


def _ssd_inputs(cuda, dtype, BC, cs, H, P, N, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xdt = torch.randn((BC, cs, H, P), generator=g, device=cuda)
    dA = -torch.randn((BC, H, cs), generator=g, device=cuda).abs() * 0.1
    Bc = torch.randn((BC, cs, N), generator=g, device=cuda)
    Cc = torch.randn((BC, cs, N), generator=g, device=cuda)
    return [t.to(dtype) for t in (xdt, dA, Bc, Cc)]


# the kernel's edges: H not a multiple of its 8-head group, cs = 200 (a
# ragged last strip), one strip at cs = 64, a chunk wider than the 256 G
# columns a block keeps at once
SSD_EDGES = [(2, 256, 5, 64, 128), (1, 256, 25, 64, 128),
             (2, 200, 3, 64, 128), (4, 64, 24, 64, 128),
             (1, 600, 3, 64, 32)]


@pytest.mark.parametrize("BC,cs,H,P,N", [(4, 16, 3, 8, 8), (2, 64, 2, 16, 16),
                                         (1, 128, 1, 64, 128),
                                         (3, 32, 4, 8, 32), (2, 20, 3, 5, 7),
                                         (2, 256, 4, 64, 128),
                                         (1, 100, 2, 80, 150)] + SSD_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, BC, cs, H, P, N, dtype):
    args = _ssd_inputs(cuda, dtype, BC, cs, H, P, N)
    before = ssd_ops.ssd_launches
    got = ssd_ops.intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_launches == before + 1
    want = ssd_ref.intra_chunk(*args)
    for g_, w, base in zip(got, want, (3e-4, 3e-4, 1e-5)):
        assert g_.dtype == torch.float32 and g_.shape == w.shape
        assert float((g_ - w).abs().max()) < ssd_tol(w, base)


@pytest.mark.parametrize("BC,cs,H,P,N", [(2, 20, 3, 5, 7), (8, 256, 24, 64, 128)]
                         + SSD_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_repeats_bitwise(cuda, BC, cs, H, P, N, dtype):
    """No atomics: three launches on the same inputs give the same bits."""
    args = _ssd_inputs(cuda, dtype, BC, cs, H, P, N, seed=3)
    runs = [ssd_ops.intra_chunk(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def test_ssd_scan_on_the_card_matches_the_plain_scan(cuda):
    from repro_torch.models import ssm
    g = torch.Generator(device=cuda).manual_seed(2)
    B, L, H, P, N = 2, 64, 3, 8, 16
    xh = torch.randn((B, L, H, P), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, H), generator=g, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    Bm = torch.randn((B, L, N), generator=g, device=cuda)
    Cm = torch.randn((B, L, N), generator=g, device=cuda)
    for chunk in (8, 16, 32):
        Y, f = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk)
        Yr, fr = ssm.ssd_scan(xh, dt, A, Bm, Cm, chunk)
        assert float((Y - Yr).abs().max()) < 2e-4
        assert float((f - fr).abs().max()) < 2e-4


@pytest.mark.parametrize("name,counter", [("qwen3-1.7b", "flash"),
                                          ("mamba2-130m", "ssd")])
def test_lm_on_the_card_matches_the_cpu(cuda, name, counter):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import transformer as tf
    cfg = smoke_config(name)
    params = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    on_card = {"embed": {k: t.to(cuda) for k, t in params["embed"].items()},
               "final_norm": params["final_norm"].to(cuda),
               "layers": [{k: ({kk: t.to(cuda) for kk, t in v.items()}
                               if isinstance(v, dict) else v.to(cuda))
                           for k, v in p.items()} for p in params["layers"]]}
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    attn_ops.reset_counts()
    ssd_ops.reset_counts()
    got, _ = tf.forward(on_card, toks.to(cuda), cfg,
                        compute_dtype=torch.float32)
    launches = {"flash": attn_ops.flash_launches,
                "ssd": ssd_ops.ssd_launches}
    assert launches[counter] == cfg.n_layers
    want, _ = tf.forward(params, toks, cfg, compute_dtype=torch.float32)
    assert float((got.cpu() - want).abs().max()) < 1e-3


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "whisper-medium"])
def test_moe_and_encdec_on_the_card_match_the_cpu(cuda, name):
    """MoE dispatch (einsum) and whisper's encoder and cross-attention on
    the card against the CPU's plain path, float32 at smoke widths; every
    attention launches the flash kernel, the encoder's and the cross
    attention's without the causal mask."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import transformer as tf
    cfg = smoke_config(name)
    params = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model),
                         generator=torch.Generator().manual_seed(2))
    f32 = torch.float32

    def run(p, device):
        enc = (tf.encode(p, frames.to(device), cfg, compute_dtype=f32)
               if cfg.enc_dec else None)
        return tf.forward(p, toks.to(device), cfg, enc_kv=enc,
                          compute_dtype=f32)

    attn_ops.reset_counts()
    got, aux = run(_to(params, cuda), cuda)
    torch.cuda.synchronize()
    n_cross = cfg.n_layers if cfg.enc_dec else 0
    assert attn_ops.flash_launches == cfg.n_layers + cfg.enc_layers + n_cross
    assert attn_ops.flash_noncausal_launches == cfg.enc_layers + n_cross
    want, want_aux = run(params, "cpu")
    assert float((got.cpu() - want).abs().max()) < 1e-3
    assert float(aux.dropped) == float(want_aux.dropped)


# --- routed pPIC serving (scatter, invariants, overflow) ---------------------

@pytest.mark.parametrize("kind", ["random", "skewed"])
@pytest.mark.parametrize("n,M,tile,max_groups", [(24, 4, 1, None),
                                                 (256, 20, 8, None),
                                                 (64, 8, 8, 1)])
def test_scatter_indices_on_the_card_equal_the_cpu(cuda, kind, n, M, tile,
                                                   max_groups):
    from repro_torch.parallel import runner
    rng = np.random.default_rng(n + M)
    X = torch.tensor(rng.normal(size=(n, 5)), dtype=torch.float32)
    a = torch.tensor(rng.integers(0, M, size=n) if kind == "random"
                     else np.full(n, M - 1))
    kw = dict(tile=tile, max_groups=max_groups)
    lay = runner.scatter_two_bucket(X, a, M, **kw)
    lay_c = runner.scatter_two_bucket(X.to(cuda), a.to(cuda), M, **kw)
    for f in lay._fields:
        want, got = getattr(lay, f), getattr(lay_c, f)
        assert (want is None) == (got is None), f
        if want is not None:
            assert torch.equal(got.cpu(), want), f
    got = runner.gather_two_bucket(lay_c.Xb, lay_c.Xo, lay_c)
    assert torch.equal(got.cpu(),
                       runner.gather_two_bucket(lay.Xb, lay.Xo, lay))
    by = runner.scatter_by_block(X, a, M)
    by_c = runner.scatter_by_block(X.to(cuda), a.to(cuda), M)
    for want, got in zip(by, by_c):
        assert torch.equal(got.cpu(), want)


def _fitted_ppic(cuda, n_train=4096, M=8, s_size=256):
    """pPIC fitted in float32 on the card from co-clustered AIMPEAK-like
    data (seed 0), through the kernels; its routed plan and test queries."""
    from repro_torch.core import api, clustering, covariance as cov, support
    from repro_torch.data import synthetic
    from repro_torch.parallel.runner import VmapRunner
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=n_train, n_test=512, seed=0, device=cuda))
    Xc, yc, Uc, _, _ = clustering.cocluster(
        ds.X.cpu().numpy(), ds.y.cpu().numpy(), ds.X_test.cpu().numpy(), M,
        0)
    spec = cov.make_spec("se")
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             device=cuda)
    S = support.select_support(spec, params, ds.X[:8 * s_size], s_size,
                               device=cuda)
    model = api.fit("ppic", spec, params, torch.as_tensor(Xc),
                    torch.as_tensor(yc), S=S, runner=VmapRunner(M=M),
                    device=cuda)
    return model, torch.as_tensor(Uc).to(cuda)


def test_routed_permutation_is_bitwise_on_the_card(cuda):
    from repro_torch.core import api
    model, U = _fitted_ppic(cuda)
    plan = model.plan(api.ServeSpec(max_batch=256, routed=True)).warmup(5)
    ops.reset_counts()
    m, v = plan.routed_diag(U[:256])
    assert ops.rbf_launches > 0
    for seed in range(3):
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(256),
                               device=cuda)
        mp, vp = plan.routed_diag(U[:256][perm])
        assert torch.equal(mp, m[perm]) and torch.equal(vp, v[perm])
    assert bool(torch.isfinite(m).all()) and bool((v > 0).all())


def test_routed_skewed_batch_overflows_and_matches_capacity_on_the_card(cuda):
    """Skewed traffic takes g > 0 and equals the capacity-|U| layout
    bitwise: every stage of the per-block program runs through the row
    products, whose arithmetic for a row does not depend on the batch."""
    from repro_torch.core import api, ppic
    model, _ = _fitted_ppic(cuda)
    plan = model.plan(api.ServeSpec(max_batch=256, routed=True))
    c = model.state.centroids[0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    U = c[None, :] + 0.05 * torch.randn(256, 5, device=cuda, generator=gen)
    m, v = plan.routed_diag(U)
    assert plan.stats.last_g > 0
    m_c, v_c = ppic.predict_routed_diag_capacity(plan.kfn, model.params,
                                                 model.state, U)
    assert torch.equal(m, m_c) and torch.equal(v, v_c)


def test_routed_cinv_and_degraded_rows_on_the_card(cuda):
    from repro_torch.core import api, ppic
    model, U = _fitted_ppic(cuda)
    base = model.plan(api.ServeSpec(max_batch=256, routed=True))
    cinv = model.plan(api.ServeSpec(max_batch=256, routed=True,
                                    cached_cinv=True))
    m0, v0 = base.routed_diag(U[:256])
    m1, v1 = cinv.routed_diag(U[:256])
    assert float((m1 - m0).abs().max()) < 1e-3
    assert float((v1 - v0).abs().max()) < 1e-3
    alive = np.ones(8, bool)
    alive[3] = False
    ops.reset_counts()
    m, v = base.routed_diag(U[:256], block_alive=alive)
    deg = torch.as_tensor(base.stats.last_degraded, device=cuda)
    assert bool(deg.any()) and ops.xcov_launches == 1
    m_g, v_g = ppic.global_diag(base.kfn, model.params, model.state,
                                U[:256])
    assert torch.equal(m[deg], m_g[deg]) and torch.equal(v[deg], v_g[deg])
    assert torch.equal(m[~deg], m0[~deg]) and torch.equal(v[~deg], v0[~deg])


def _pitc_server(cuda, **kw):
    """A pPITC server on the card over AIMPEAK-like data (seed 0, float32)
    and its test queries on the host."""
    from repro_torch.core import api, covariance as cov
    from repro_torch.data import synthetic
    from repro_torch.launch.gp_serve import GPServer
    from repro_torch.parallel.runner import VmapRunner
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=4096, n_test=256, seed=0, device=cuda))
    spec = cov.make_spec("se")
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             device=cuda)
    store = api.init_store("ppitc", spec, params, ds.X, ds.y,
                           S=ds.X[:256], runner=VmapRunner(M=8), device=cuda)
    model = api.FittedGP(api.get("ppitc"), spec, params, store.to_state())
    srv = GPServer(model, spec=api.ServeSpec(max_batch=64), store=store,
                   **kw)
    return srv, ds.X_test.cpu().numpy()


def test_flush_tickets_are_device_tensors_resolved_after_their_event(cuda):
    srv, U = _pitc_server(cuda)
    srv.plan.warmup(5)
    tickets = [srv.submit(x) for x in U[:40]]
    srv.flush()
    events = {id(srv._t.ready_events[tk]) for tk in tickets}
    assert len(events) == 1                  # one event per flush
    event = srv._t.ready_events[tickets[0]]
    assert isinstance(event, torch.cuda.Event)
    got = [srv.result(tk) for tk in tickets]
    assert event.query()
    assert all(m.is_cuda and v.is_cuda for m, v in got)
    m, v = srv.plan.diag(U[:40])
    assert torch.equal(torch.stack([g[0] for g in got]), m)
    assert torch.equal(torch.stack([g[1] for g in got]), v)
    more = [srv.submit(x) for x in U[40:50]]
    srv.flush()
    srv.sync()
    assert srv._t.ready_events[more[0]].query()


def test_a_cuda_tensor_point_is_staged_on_the_host(cuda):
    srv, U = _pitc_server(cuda)
    a = srv.submit(U[0])
    b = srv.submit(torch.as_tensor(U[0]).to(cuda))
    assert isinstance(srv._t.queue[1][1], np.ndarray)
    srv.flush()
    (ma, va), (mb, vb) = srv.result(a), srv.result(b)
    assert ma.is_cuda and torch.equal(ma, mb) and torch.equal(va, vb)


def test_load_state_and_store_default_to_the_card(cuda, tmp_path):
    from repro_torch.core import serialize
    srv, _ = _pitc_server(cuda)
    path = serialize.save_state(tmp_path / "s.npz", srv.model.state)
    back = serialize.load_state(path)
    for a, b in zip(srv.model.state, back):
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b)
    spath = serialize.save_store(tmp_path / "t.npz", srv.store)
    store = serialize.load_store(spath)
    assert store.S.is_cuda and store.store.alive.is_cuda
    for a, b in zip(srv.store.to_state(), store.to_state()):
        assert torch.equal(a, b)


def test_chaos_poison_writes_nan_on_the_device(cuda):
    from repro_torch.serving import FaultInjector, FaultPlan
    from repro_torch.serving.chaos import poison_state
    inj = FaultInjector(FaultPlan(nan_at={1: 0}))
    inj.before_dispatch(None, None)
    mean = torch.arange(6, dtype=torch.float32, device=cuda)
    assign = np.array([0, 1, 1, 2, 1, 0])
    m, v = inj.poison(assign, mean, mean + 1)
    assert m.is_cuda and v.is_cuda and not torch.isnan(mean).any()
    assert torch.isnan(m).cpu().tolist() == list(assign == 1)
    model, _ = _fitted_ppic(cuda)
    bad = poison_state(model.state, 2)
    assert bad.C_L.is_cuda and torch.isnan(bad.C_L[2]).all()
    assert not torch.isnan(model.state.C_L).any()


def test_health_ladder_heals_a_poisoned_block_on_the_card(cuda, tmp_path):
    """A NaN-poisoned block is retired, its rows served degraded through
    xcov_diag with every ticket finite, and revived from its store
    checkpoint to the unpoisoned output bitwise."""
    from repro_torch.core import api, clustering, covariance as cov, \
        serialize, support
    from repro_torch.data import synthetic
    from repro_torch.launch.gp_serve import GPServer
    from repro_torch.parallel.runner import VmapRunner
    from repro_torch.serving import HealthPolicy
    from repro_torch.serving.chaos import poison_state
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=4096, n_test=256, seed=0, device=cuda))
    Xc, yc, _, _, _ = clustering.cocluster(
        ds.X.cpu().numpy(), ds.y.cpu().numpy(), ds.X_test.cpu().numpy(), 8,
        0)
    spec = cov.make_spec("se")
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             device=cuda)
    S = support.select_support(spec, params, ds.X[:2048], 256, device=cuda)
    store = api.init_store("ppic", spec, params, torch.as_tensor(Xc),
                           torch.as_tensor(yc), S=S, runner=VmapRunner(M=8),
                           device=cuda)
    model = api.FittedGP(api.get("ppic"), spec, params, store.to_state())
    sspec = api.ServeSpec(max_batch=256, routed=True)
    ckpt = tmp_path / "pic.npz"
    serialize.save_store(ckpt, store, spec=sspec)
    srv = GPServer(model, spec=sspec, store=store,
                   health=HealthPolicy(max_consecutive_failures=1,
                                       checkpoint=ckpt))
    srv.plan.warmup(5)
    U = ds.X_test.cpu().numpy()

    def serve():
        tk = [srv.submit(x) for x in U]
        srv.flush()
        return [srv.collect(k) for k in tk]

    before = serve()
    assign = clustering.nearest_center_np(U, srv.plan._centroids_host)
    k = int(np.bincount(assign).argmax())
    srv.swap_state(poison_state(srv.model.state, k))
    ops.reset_counts()
    during = serve()
    assert ops.xcov_launches >= 1 and srv.health.dead_blocks() == [k]
    assert [bool(d) for _, _, d in during] == list(assign == k)
    assert all(bool(torch.isfinite(m)) and bool(torch.isfinite(v))
               for m, v, _ in during)
    srv.pump()
    assert srv.stats.n_revives == 1 and srv.health.dead_blocks() == []
    for (m0, v0, _), (m1, v1, d) in zip(before, serve()):
        assert not d and torch.equal(m0, m1) and torch.equal(v0, v1)


# -- the GP programs over two gloo ranks sharing the card --------------------

DIST_TOL = 1e-8      # float64; the ranks' psums add in another order


def _dist_problem(dev):
    rng = np.random.default_rng(0)
    X, S, U = (rng.normal(size=(k, 3)) for k in (128, 12, 32))
    y = np.sin(X[:, 0]) * 2 + X[:, 1] + 0.1 * rng.normal(size=128)
    return tuple(torch.tensor(a, device=dev) for a in (X, S, U, y))


def _dist_programs(runner, dev):
    from repro_torch.core import covariance as cov, picf, ppitc
    X, S, U, y = _dist_problem(dev)
    params = cov.init_params(3, signal=1.3, noise=0.3, lengthscale=1.5,
                             dtype=torch.float64, device=dev)
    kfn = cov.make_spec("se")
    post = ppitc.predict_distributed(kfn, params, S, X, y, U, runner)
    loc = picf.icf_factor_local(kfn, params, runner.shard_blocks(X), 48,
                                axis_name=runner.axis)
    return {"mean": post.mean, "blocks": post.blocks,
            "F": runner.gather(loc.F), "pivots": loc.pivots[0]}


def _gloo_rank(rank, rdv, q):
    import torch.distributed as dist
    try:
        from repro_torch.launch import mesh as tmesh
        from repro_torch.parallel.runner import ShardMapRunner
        dev = torch.device("cuda", 0)
        mesh = tmesh.make_mesh((2,), ("data",), rank=rank, world_size=2,
                               init_method=f"file://{rdv}", backend="gloo",
                               device=dev, timeout_s=120)
        sm = ShardMapRunner(mesh=mesh, axis_name="data", local_machines=4)
        before = ops.rbf_launches, ops.rbf_exact_launches
        # numpy, pickled by value: a tensor would travel as shared memory
        # that the rank's exit takes with it
        out = {k: v.cpu().numpy() for k, v in _dist_programs(sm, dev).items()}
        out["rbf_launches"] = ops.rbf_launches - before[0]
        out["rbf_exact_launches"] = ops.rbf_exact_launches - before[1]
        q.put((rank, out, None))
    except Exception:
        import traceback
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_gp_programs_over_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """``ppitc.predict_distributed`` and ``picf.icf_factor_local`` on two
    gloo ranks sharing the card (four machines each) against the stacked
    axis on the card: float64 within DIST_TOL, pivots equal, and the rbf
    kernel (its exact instance for the pivot columns too) launched in each
    rank. The loop's pivots are the ICF kernel's (``picf.factor`` on a
    ``VmapRunner``): in float64 the pivot column takes its arithmetic."""
    import torch.multiprocessing as mp
    from repro_torch.parallel.runner import VmapRunner
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "rdv"),
                                                  q), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    want = {k: v.cpu().numpy() for k, v in _dist_programs(VmapRunner(M=8),
                                                          cuda).items()}
    from repro_torch.core import covariance as cov, picf
    X = _dist_problem(cuda)[0]
    params = cov.init_params(3, signal=1.3, noise=0.3, lengthscale=1.5,
                             dtype=torch.float64, device=cuda)
    icf_before = ops.icf_launches
    kern = picf.factor(cov.make_spec("se"), params, X, 48, VmapRunner(M=8))
    assert ops.icf_launches == icf_before + 1
    assert np.array_equal(kern.pivots[0].cpu().numpy(), want["pivots"])
    got = {}
    try:
        for _ in procs:
            rank, out, tb = q.get(timeout=300)
            assert tb is None, tb
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank, out in got.items():
        assert out["rbf_launches"] > 0, rank
        assert out["rbf_exact_launches"] >= 48, rank
        assert np.array_equal(out["pivots"], want["pivots"]), rank
        for k in ("mean", "blocks", "F"):
            err = float(np.abs(out[k] - want[k]).max())
            assert err < DIST_TOL, (rank, k, err)


# --- the backward kernels ------------------------------------------------------

# (B, Hq, Hkv, Tq, Tk, D, window, q_offset, causal): causal, sliding window,
# non-causal (Tq != Tk, whisper's cross shape cut down), GQA 4:1, q_offset,
# D in {64, 128, 256} and 12 (padded to 16 in bf16), ragged tiles, a row
# with no valid key (window 2 at offset 20 over 8 keys)
FLASH_BWD_CASES = [(2, 4, 2, 128, 128, 64, None, 0, True),
                   (1, 4, 4, 200, 200, 128, None, 0, True),
                   (1, 2, 2, 300, 300, 256, 100, 0, True),
                   (1, 4, 1, 96, 96, 12, None, 0, True),
                   (1, 8, 2, 130, 130, 64, 48, 0, True),
                   (2, 4, 4, 45, 150, 64, None, 0, False),
                   (1, 4, 2, 100, 200, 128, None, 100, True),
                   (1, 2, 2, 33, 70, 256, None, 0, False),
                   (1, 2, 2, 4, 8, 64, 2, 20, True)]
# max|err| <= tol x max|want| per gradient. f32: rounding order only.
# bf16: P and dS are rounded to bf16 for their products (2^-9 a term) and
# dq, dk, dv to bf16 (2^-8); the plain version differentiates in float32
# from the same bf16 inputs.
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_bwd_inputs(cuda, dtype, B, Hq, Hkv, Tq, Tk, D, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    shapes = ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D),
              (B, Hq, Tq, D))
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in shapes]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,off,causal",
                         FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain(cuda, B, Hq, Hkv, Tq, Tk, D,
                                             window, off, causal, dtype):
    q, k, v, do = _flash_bwd_inputs(cuda, dtype, B, Hq, Hkv, Tq, Tk, D)
    kw = dict(causal=causal, window=window, q_offset=off)
    with torch.no_grad():
        out = attn_ops.attention(q, k, v, **kw)
    before = attn_ops.flash_bwd_launches
    runs = [attn_ops.attention_backward(q, k, v, out, do, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert attn_ops.flash_bwd_launches == before + 2
    want = attn_ref.attention_backward(q, k, v, do, **kw)
    for got, again, w, name in zip(runs[0], runs[1], want, "qkv"):
        assert torch.equal(got, again), name          # no atomics
        assert got.dtype == dtype and got.shape == w.shape
        scale = float(w.abs().max())
        err = float((got.float() - w).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * scale + 1e-6, (name, err, scale)


def test_flash_backward_rows_without_a_key_are_zero(cuda):
    q, k, v, do = _flash_bwd_inputs(cuda, torch.bfloat16, 1, 2, 2, 4, 8, 64)
    dq, dk, dv = attn_ops.attention_backward(
        q, k, v, torch.zeros_like(q), do, causal=True, window=2, q_offset=20)
    for t in (dq, dk, dv):
        assert torch.equal(t, torch.zeros_like(t))


def test_flash_backward_strided_views_and_autograd(cuda):
    """q, k, v as (B, T, H, D) buffers seen as (B, H, T, D), through
    autograd: the same gradients as contiguous copies."""
    ts = _flash_bwd_inputs(cuda, torch.bfloat16, 2, 8, 4, 80, 80, 64, seed=1)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
             for t in ts[:3]]
    conts = [t.detach().contiguous().requires_grad_() for t in views]
    for leaves in (views, conts):
        attn_ops.attention(*leaves).backward(ts[3])
    for a, b in zip(views, conts):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_in_trainings_layout_matches_plain(cuda, dtype):
    """q, k, v and dO as (B, H, T, D) views of (B, T, H, D) buffers, as a
    training step hands them over (qwen3's heads, D = 128), against the
    plain version."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, Hq, Hkv, T, D = 2, 16, 8, 256, 128
    q, k, v, do = (torch.randn((B, T, H, D), generator=g, device=cuda)
                   .to(dtype).transpose(1, 2) for H in (Hq, Hkv, Hkv, Hq))
    with torch.no_grad():
        out = attn_ops.attention(q, k, v)
    got = attn_ops.attention_backward(q, k, v, out, do)
    want = attn_ref.attention_backward(q, k, v, do)
    for a, w, name in zip(got, want, "qkv"):
        scale = float(w.abs().max())
        err = float((a.float() - w).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * scale + 1e-6, (name, err, scale)


def test_flash_f32_backward_is_the_forwards_derivative(cuda):
    """gradcheck-style: the f32 backward kernel's directional derivative
    of <attention(q, k, v), dO> against a central difference of the f32
    forward kernel (eps 1e-2: truncation ~1e-4, rounding ~1e-4 of the
    derivative's size)."""
    q, k, v, do = _flash_bwd_inputs(cuda, torch.float32, 1, 4, 2, 40, 40, 16,
                                    seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    dirs = [torch.randn(t.shape, generator=g, device=cuda) for t in (q, k, v)]
    for kw in (dict(causal=True), dict(causal=True, window=9),
               dict(causal=False)):
        with torch.no_grad():
            out = attn_ops.attention(q, k, v, **kw)
            grads = attn_ops.attention_backward(q, k, v, out, do, **kw)
            eps = 1e-2

            def loss(sign):
                args = [t + sign * eps * d for t, d in zip((q, k, v), dirs)]
                return float((attn_ops.attention(*args, **kw).double()
                              * do.double()).sum())

            fd = (loss(1) - loss(-1)) / (2 * eps)
        an = sum(float((gr.double() * d.double()).sum())
                 for gr, d in zip(grads, dirs))
        assert abs(an - fd) <= 1e-2 * abs(an), (kw, an, fd)


# the last two have several heads a block (mamba2 training's split, 3
# groups of 8, and 2 groups of 4 and 3), the others one
SSD_BWD_CASES = [(4, 16, 3, 8, 8), (2, 64, 3, 16, 32), (2, 20, 3, 5, 7),
                 (1, 100, 2, 80, 150), (2, 256, 24, 64, 128),
                 (3, 200, 5, 64, 128), (1, 600, 2, 64, 32),
                 (128, 32, 24, 16, 32), (200, 16, 7, 8, 8)]
# max|err| <= tol x max|want| per gradient: f32 rounding order only (the
# kernel's cumsum and products sum in other orders); bf16 inputs are
# differentiated in f32 by both, the kernel's gradients rounded to bf16.
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("BC,cs,H,P,N", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_matches_plain(cuda, BC, cs, H, P, N, dtype):
    args = _ssd_inputs(cuda, dtype, BC, cs, H, P, N, seed=8)
    g = torch.Generator(device=cuda).manual_seed(9)
    douts = [torch.randn(s, generator=g, device=cuda)
             for s in ((BC, cs, H, P), (BC, H, P, N), (BC, H, cs))]
    before = ssd_ops.ssd_bwd_launches
    runs = [ssd_ops.intra_chunk_backward(*args, *douts) for _ in range(2)]
    torch.cuda.synchronize()
    assert ssd_ops.ssd_bwd_launches == before + 2
    want = ssd_ref.intra_chunk_backward(*args, *douts)
    for got, again, w, name in zip(runs[0], runs[1], want,
                                   ("dxdt", "ddA", "dB", "dC")):
        assert torch.equal(got, again), name          # no atomics
        assert got.dtype == dtype and got.shape == w.shape
        scale = float(w.abs().max())
        err = float((got.float() - w).abs().max())
        assert err <= SSD_BWD_TOL[dtype] * scale + 1e-6, (name, err, scale)


def test_ssd_backward_without_some_output_gradients(cuda):
    """dS and dcum absent (None) read as zero, as autograd passes them when
    only Y feeds the loss."""
    args = _ssd_inputs(cuda, torch.float32, 2, 64, 3, 16, 32, seed=10)
    dY = torch.randn((2, 64, 3, 16), device=cuda)
    got = ssd_ops.intra_chunk_backward(*args, dY, None, None)
    want = ssd_ref.intra_chunk_backward(*args, dY, None, None)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# --- the forward's log-sum-exp and the backward's wgmma route -----------------

# the forward's LSE against the plain one, natural log (chip_smoke.py's
# TOL_LSE: float32 sums in other orders and the hardware exp2 / log2)
LSE_TOL = 1e-4
LSE_CASES = [(2, 4, 2, 200, 200, 64, None, 0, True),
             (1, 4, 4, 130, 130, 128, 48, 0, True),
             (1, 4, 2, 100, 200, 128, None, 100, True),
             (2, 4, 4, 45, 150, 64, None, 0, False),
             (1, 2, 2, 33, 70, 256, None, 0, True),
             (1, 4, 1, 96, 96, 12, None, 0, True),
             (1, 2, 2, 4, 8, 64, 2, 20, True)]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,off,causal", LSE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_matches_plain_and_leaves_the_output(
        cuda, B, Hq, Hkv, Tq, Tk, D, window, off, causal, dtype):
    q, k, v, _ = _flash_bwd_inputs(cuda, dtype, B, Hq, Hkv, Tq, Tk, D,
                                   seed=12)
    kw = dict(causal=causal, window=window, q_offset=off)
    out, lse = attn_ops.attention_with_lse(q, k, v, **kw)
    assert torch.equal(out, attn_ops.attention(q, k, v, **kw))
    want = attn_ref.attention_lse(q, k, **kw)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    keyed = torch.isfinite(want)
    assert torch.equal(torch.isneginf(lse), ~keyed)
    if keyed.any():
        assert float((lse[keyed] - want[keyed]).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("D,dtype,wgmma", [(64, torch.bfloat16, True),
                                           (128, torch.bfloat16, True),
                                           (256, torch.bfloat16, False),
                                           (12, torch.bfloat16, False),
                                           (128, torch.float32, False)])
def test_flash_backward_route_and_repeat(cuda, D, dtype, wgmma):
    """bf16 at D = 64 and 128 takes the wgmma kernels (from the forward's
    LSE, through autograd as training records it), D = 256, the padded D
    and float32 the two-pass kernels; two launches give the same bits and
    the plain version's gradients."""
    q, k, v, do = _flash_bwd_inputs(cuda, dtype, 2, 4, 2, 192, 192, D,
                                    seed=13)
    assert (attn_ops.bwd_route(q, k, v, do) == "sm90") == wgmma
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (attn_ops.flash_bwd_launches, attn_ops.flash_bwd_sm90_launches)
    runs = [torch.autograd.grad(attn_ops.attention(*leaves), leaves, do)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert attn_ops.flash_bwd_launches == before[0] + 2
    assert attn_ops.flash_bwd_sm90_launches == before[1] + 2 * wgmma
    want = attn_ref.attention_backward(q, k, v, do)
    for got, again, w, name in zip(runs[0], runs[1], want, "qkv"):
        assert torch.equal(got, again), name          # no atomics
        err = float((got.float() - w).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * float(w.abs().max()) + 1e-6, \
            (name, err)


def test_ssd_backward_repeats_bitwise_at_the_training_split(cuda):
    """mamba2 training's split (BC = 96 gives 3 groups of 8 heads, as its
    BC = 128 does) and a ragged chunk longer than the G block (600 rows):
    two launches, the same bits."""
    assert ssd_ops.bwd_head_groups(96, 24) == (8, 3)
    for BC, cs, H, P, N in ((96, 256, 24, 64, 128), (1, 600, 5, 64, 32)):
        args = _ssd_inputs(cuda, torch.float32, BC, cs, H, P, N, seed=14)
        g = torch.Generator(device=cuda).manual_seed(15)
        douts = [torch.randn(s, generator=g, device=cuda)
                 for s in ((BC, cs, H, P), (BC, H, P, N), (BC, H, cs))]
        runs = [ssd_ops.intra_chunk_backward(*args, *douts)
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


# --- the row products of pPIC's routed diag ------------------------------------

def _rows_case(cuda, dtype, nblk, u, K, N, trans, lower, table, c0, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    P, Q = (N, K) if trans else (K, N)
    nt = nblk + 2 if table else 1
    X = torch.randn((nblk, u, K), generator=g, device=cuda, dtype=dtype)
    B = torch.randn((nt, P, Q), generator=g, device=cuda, dtype=dtype) \
        / K ** 0.5
    if lower:
        B = torch.tril(B)
    idx = torch.randint(0, nt, (nblk,), generator=g, device=cuda) \
        if table else None
    C0 = torch.randn((nblk, u, N), generator=g, device=cuda, dtype=dtype) \
        if c0 else None
    return X, (B if table else B[0]), idx, C0


ROWS_CASES = [(nblk, u, K, trans, lower, table, c0)
              for nblk, u, K in ((20, 32, 2048), (3, 33, 71), (2, 1, 8),
                                 (5, 65, 130))
              for trans, lower, table, c0 in ((True, True, False, False),
                                              (False, False, True, True),
                                              (False, True, True, False),
                                              (True, False, True, True))]


@pytest.mark.parametrize("nblk,u,K,trans,lower,table,c0", ROWS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_mm_kernel_matches_plain(cuda, dtype, nblk, u, K, trans, lower,
                                      table, c0):
    """float64 bitwise the plain version (the same correctly rounded
    operations in the same order); float32 within 1e-4 of the scale
    max(|C0| + |X| |op B|) (chip_smoke.py's TOL_ROWS_F32: both sum K
    products in float32, the kernel's in 3xTF32). Repeated launches equal;
    ragged u, K and N."""
    from repro_torch.kernels.linalg import ops as lops, ref as lref
    N = K if lower else K // 2 + 3
    X, B, idx, C0 = _rows_case(cuda, dtype, nblk, u, K, N, trans, lower,
                               table, c0)
    before = lops.rows_mm_launches
    got = lops.rows_mm(X, B, idx, trans=trans, lower=lower, C0=C0)
    again = lops.rows_mm(X, B, idx, trans=trans, lower=lower, C0=C0)
    torch.cuda.synchronize()
    assert lops.rows_mm_launches == before + 2 and torch.equal(got, again)
    want = lref.rows_mm(X, B, idx, trans=trans, lower=lower, C0=C0)
    if dtype == torch.float64:
        assert torch.equal(got, want)
    else:
        Bs = B.abs() if B.ndim == 2 else B.abs()[idx]
        scale = float((X.abs() @ (Bs.mT if trans else Bs)).max())
        scale += 0.0 if C0 is None else float(C0.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale


ROWS_SERVING = [(u, False, False, True, True) for u in (1, 32, 336)] \
    + [(336, True, True, False, False)]


@pytest.mark.parametrize("u,trans,lower,table,c0", ROWS_SERVING)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_mm_at_the_serving_row_counts(cuda, dtype, u, trans, lower,
                                           table, c0):
    """The row counts a block takes when serving: one row, the 256-row
    request's 32 and the 3200-row request's 336 (11 query tiles, blocks of
    4, 4 and 3), through a table and on a shared lower B. float64 bitwise
    the plain version, float32 within 1e-4 of the scale; the first 32 rows
    of each block the same bits as those 32 rows alone."""
    from repro_torch.kernels.linalg import ops as lops, ref as lref
    K = 448
    N = K if lower else 320
    X, B, idx, C0 = _rows_case(cuda, dtype, 4, u, K, N, trans, lower,
                               table, c0, seed=7)
    got = lops.rows_mm(X, B, idx, trans=trans, lower=lower, C0=C0)
    want = lref.rows_mm(X, B, idx, trans=trans, lower=lower, C0=C0)
    if dtype == torch.float64:
        assert torch.equal(got, want)
    else:
        Bs = B.abs() if B.ndim == 2 else B.abs()[idx]
        scale = float((X.abs() @ (Bs.mT if trans else Bs)).max())
        scale += 0.0 if C0 is None else float(C0.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
    if u > 32:
        few = lops.rows_mm(X[:, :32], B, idx, trans=trans, lower=lower,
                           C0=None if C0 is None else C0[:, :32])
        assert torch.equal(few, got[:, :32])


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_mm_reads_strided_tables_in_place(cuda, dtype, trans):
    """A table of other strides (column-major entries, as a triangular
    solve returns them; a strided slice) gives the same bits as its
    contiguous copy."""
    from repro_torch.kernels.linalg import ops as lops
    X, B, idx, C0 = _rows_case(cuda, dtype, 4, 37, 96, 70, trans, False,
                               True, True, seed=4)
    want = lops.rows_mm(X, B, idx, trans=trans, C0=C0)
    assert torch.equal(lops.rows_mm(X, B.mT.contiguous().mT, idx,
                                    trans=trans, C0=C0), want)
    wide = torch.zeros(B.shape[:-1] + (2 * B.shape[-1],), device=cuda,
                       dtype=dtype)
    wide[..., ::2] = B
    assert torch.equal(lops.rows_mm(X, wide[..., ::2], idx, trans=trans,
                                    C0=C0), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_kernels_are_row_count_independent(cuda, dtype):
    """A row's output is the same bits alone, at another slot, inside the
    capacity-|U| batch, and as an indexed overflow group of its block."""
    from repro_torch.kernels.linalg import ops as lops
    X, B, idx, C0 = _rows_case(cuda, dtype, 6, 40, 300, 300, False, False,
                               True, True, seed=3)
    whole = lops.rows_mm(X, B, idx, C0=C0)
    big = torch.cat([X, torch.randn_like(X[:, :7]), X], 1)
    bigc = torch.cat([C0, torch.randn_like(C0[:, :7]), C0], 1)
    cap = lops.rows_mm(big, B, idx, C0=bigc)
    assert torch.equal(cap[:, :40], whole) and torch.equal(cap[:, 47:], whole)
    grp = torch.tensor([4, 4, 1], device=cuda)
    over = lops.rows_mm(X[grp], B, idx[grp], C0=C0[grp])
    assert torch.equal(over, whole[grp])
    perm = torch.randperm(40, device=cuda)
    moved = lops.rows_mm(X[:, perm], B, idx, C0=C0[:, perm])
    assert torch.equal(moved, whole[:, perm])
    one = lops.rows_mm(X[2:3, 17:18], B, idx[2:3], C0=C0[2:3, 17:18])
    assert torch.equal(one[0, 0], whole[2, 17])
    T = torch.randn_like(X[..., :100])
    kd = torch.rand_like(X[..., 0]) + 1
    args = (kd, X, X[0, 0], T, T[:, 0], None, X, T, X)
    m, v = lops.rows_reduce(*args)
    m1, v1 = lops.rows_reduce(kd[3:4, 5:6], X[3:4, 5:6], X[0, 0],
                              T[3:4, 5:6], T[:, 0], torch.tensor([3],
                                                                 device=cuda),
                              X[3:4, 5:6], T[3:4, 5:6], X[3:4, 5:6])
    assert torch.equal(m1[0, 0], m[3, 5]) and torch.equal(v1[0, 0], v[3, 5])


@pytest.mark.parametrize("cinv", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s,b", [(2048, 1600), (33, 7), (1, 64)])
def test_rows_reduce_kernel_is_bitwise_the_plain_version(cuda, dtype, cinv,
                                                         s, b):
    from repro_torch.kernels.linalg import ops as lops, ref as lref
    g = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *sh: torch.randn(sh, generator=g, device=cuda, dtype=dtype)
    nblk, u = 4, 9
    args = (r(nblk, u), r(nblk, u, s), r(s), r(nblk, u, b), r(nblk + 3, b),
            torch.tensor([6, 0, 6, 2], device=cuda), r(nblk, u, s),
            r(nblk, u, b), r(nblk, u, s))
    before = lops.rows_reduce_launches
    got = lops.rows_reduce(*args, cinv=cinv)
    torch.cuda.synchronize()
    assert lops.rows_reduce_launches == before + 1
    want = lref.rows_reduce(*args, cinv=cinv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rows_kernels_give_nan_rows_for_an_index_outside_the_table(cuda):
    from repro_torch.kernels.linalg import ops as lops
    X, B, idx, C0 = _rows_case(cuda, torch.float32, 3, 5, 16, 16, False,
                               False, True, True)
    bad = torch.tensor([0, 5, -1], device=cuda)          # 5 entries: 0..4
    Y = lops.rows_mm(X, B, bad, C0=C0)
    assert bool(torch.isfinite(Y[0]).all()) and bool(Y[1:].isnan().all())
    m, v = lops.rows_reduce(X[..., 0], X, X[0, 0], X, B[:, 0], bad, X, X, X)
    assert bool(torch.isfinite(m[0]).all()) and bool(m[1:].isnan().all())
    assert bool(v[1:].isnan().all())


def test_routed_request_launches_the_row_products_on_the_card(cuda):
    """Every stage of a routed request's per-block program launches the row
    products: six rows_mm and one rows_reduce, whatever g."""
    from repro_torch.core import api
    from repro_torch.kernels.linalg import ops as lops
    model, U = _fitted_ppic(cuda)
    plan = model.plan(api.ServeSpec(max_batch=256, routed=True)).warmup(5)
    lops.reset_counts()
    plan.routed_diag(U[:256])
    assert (lops.rows_mm_launches, lops.rows_reduce_launches) == (6, 1)
