"""The float32 xcov_diag kernel's precision, work split and inverse cache,
on the CPU.

- Precision: on a pPITC state fitted in float64 (AIMPEAK-like, |D| 4000,
  M 4, |S| 256, seed 0), the kernel's products emulated in float64 with
  float32 factors and inverses: 3xTF32 stays within a tenth of the
  fused-vs-compose gate that ``chip_smoke.py`` holds the card to, one TF32
  product misses the gate itself. The port's plain version matches the JAX
  reference's on that state in float64.
- Work split: the k-chunks of ``ops._tc_chunk`` fill the card and bound
  each block's chain at small batches, and cover every lower tile once.
- Inverse cache: ``ops.tri_inv`` builds once per factor, rebuilds for a new
  factor or an in-place edit, and forgets a freed factor.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbf import ref as jref
from repro_torch.core import api, covariance as cov, support
from repro_torch.data import synthetic
from repro_torch.kernels.rbf import ops, ref
from repro_torch.parallel.runner import VmapRunner

S_FIT = 256


@pytest.fixture(scope="module")
def fitted():
    """Scaled test queries and support, the float64 state and sig2."""
    ds = synthetic.standardize(synthetic.aimpeak_like(
        n=4000, n_test=512, seed=0, device="cpu"))
    X, y = ds.X.double(), ds.y.double()
    spec = cov.make_spec("se", impl="torch")
    params = cov.init_params(5, signal=1.0, noise=0.3, lengthscale=1.2,
                             dtype=torch.float64, device="cpu")
    S = support.select_support(spec, params, X[:2048], S_FIT, device="cpu")
    model = api.fit("ppitc", spec, params, X, y, S=S, runner=VmapRunner(M=4),
                    device="cpu")
    st = model.state
    return dict(U=cov._scale(params, ds.X_test.double()),
                Sk=cov._scale(params, st.S), st=st,
                sig2=cov.signal_var(params))


def _tf32(x: torch.Tensor, nearest: bool) -> torch.Tensor:
    """x on a 10-bit mantissa (TF32), in float64: rounded to nearest (a
    TF32 matmul's conversion) or truncated (what the tensor core reads of a
    float32 register)."""
    m, e = torch.frexp(x)
    scaled = m.abs() * 2.0 ** 11
    kept = torch.floor(scaled + 0.5) if nearest else torch.floor(scaled)
    return torch.ldexp(torch.sign(m) * kept / 2.0 ** 11, e)


def _one_tf32(a, b):
    return _tf32(a, True) @ _tf32(b, True)


def _three_tf32(a, b):
    """The kernel's split: hi = x as the tensor core reads it, lo the exact
    remainder, read the same way; hi hi' + lo hi' + hi lo'."""
    ah, bh = _tf32(a, False), _tf32(b, False)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return ah @ bh + al @ bh + ah @ bl


def test_3xtf32_meets_the_fused_gate_and_tf32_does_not(fitted):
    U, Sk, st, sig2 = (fitted[k] for k in ("U", "Sk", "st", "sig2"))
    _, v64 = ref.xcov_diag(U, Sk, st.Kss_L, st.alpha, sig2, st.Sdd_L)
    L1, L2 = st.Kss_L.float(), st.Sdd_L.float()
    # the compose path in float32 (plain solves) and chip_smoke.py's gate
    _, v_c = ref.xcov_diag(U.float(), Sk.float(), L1, st.alpha.float(),
                           sig2.float(), L2)
    gate = 10 * float((v_c.double() - v64).abs().max()) + 1e-4
    # the kernel's operands: K_US and the inverses in float32
    Uf, Sf = U.float(), Sk.float()
    d2 = (Uf * Uf).sum(1)[:, None] + (Sf * Sf).sum(1)[None] - 2 * Uf @ Sf.T
    K = (sig2.float() * torch.exp(-0.5 * d2.clamp(min=0))).double().T
    I1, I2 = ops.tri_inv(L1).double(), ops.tri_inv(L2).double()
    errs = {}
    for name, prod in (("3xtf32", _three_tf32), ("1xtf32", _one_tf32)):
        v1, v2 = prod(I1, K), prod(I2, K)        # V^T = L^{-1} K_US^T
        var = float(sig2) - (v1 * v1).sum(0) + (v2 * v2).sum(0)
        errs[name] = float((var - v64).abs().max())
    assert errs["3xtf32"] < gate / 10, (errs, gate)
    assert errs["1xtf32"] > gate, (errs, gate)


def test_plain_matches_the_jax_reference_on_a_fitted_state(fitted):
    U, Sk, st, sig2 = (fitted[k] for k in ("U", "Sk", "st", "sig2"))
    j = [jnp.asarray(t.numpy()) for t in (U, Sk, st.Kss_L, st.alpha,
                                          st.Sdd_L)]
    for with_l2 in (True, False):
        got = ref.xcov_diag(U, Sk, st.Kss_L, st.alpha, sig2,
                            st.Sdd_L if with_l2 else None)
        want = jref.xcov_diag(j[0], j[1], j[2], j[3], float(sig2),
                              j[4] if with_l2 else None)
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-10


# --- the float32 kernel's work split -----------------------------------------

def _chunks(s: int, kc: int) -> list[tuple[int, int, int]]:
    """(panel, k_lo, k_hi) of every block of one query tile, in the
    kernel's order: from the last 64-row panel down, chunks in order."""
    out = []
    for p in reversed(range(-(-s // 64))):
        k_end = min(64 * (p + 1), s)
        out += [(p, k, min(k + kc, k_end)) for k in range(0, k_end, kc)]
    return out


@pytest.mark.parametrize("n", [1, 8, 64, 65, 256, 257, 3328])
def test_tc_chunk_fills_the_card_and_bounds_the_chain(n):
    """At |S| = 2048: small batches get at least 132 blocks (one per SM)
    and no block runs more than 16 k-steps of 32 up to n = 256; larger
    batches fill the card with query tiles and keep the panels whole."""
    s = 2048
    kc = ops._tc_chunk(n, s)
    units = ops._tc_units(s, kc)
    assert units == len(_chunks(s, kc))
    tiles = -(-n // ops._kernel_tile(n, None, torch.float32))
    if n <= 256:
        assert units * tiles >= 132 and kc // 32 <= 16
    else:
        assert kc >= s and units == s // 64


@pytest.mark.parametrize("s", [100, 2047, 2048, 2049])
@pytest.mark.parametrize("kc", [64, 256, 512, 4096])
def test_tc_chunks_cover_each_lower_tile_once(s, kc):
    """Each panel's chunks tile [0, min(64 (p + 1), s)) once, and the last
    holds the panel's own 64 support points (its share of the mean)."""
    blocks = _chunks(s, kc)
    assert len(blocks) == ops._tc_units(s, kc)
    for p in range(-(-s // 64)):
        mine = [(lo, hi) for q, lo, hi in blocks if q == p]
        edges = [lo for lo, _ in mine] + [mine[-1][1]]
        assert edges[0] == 0 and edges[-1] == min(64 * (p + 1), s)
        assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        assert mine[-1][0] <= 64 * p


def test_tc_chunk_caps_the_split_scratch():
    for n, s in ((256, 8192), (64, 16384), (256, 2048)):
        kc = ops._tc_chunk(n, s)
        assert kc % 64 == 0
        if ops._tc_units(s, kc) > -(-s // 64):       # split
            assert ops._tc_units(s, kc) * 2 * 64 * n * 4 <= 64 * 2 ** 20


# --- the inverse cache -------------------------------------------------------

def _factor(s: int, seed: int = 0) -> torch.Tensor:
    a = torch.tensor(np.random.default_rng(seed).normal(size=(s, s)))
    return torch.linalg.cholesky(a @ a.T + s * torch.eye(s, dtype=a.dtype))


def test_tri_inv_is_built_once_per_factor():
    ops.reset_counts()
    L = _factor(40)
    first = ops.tri_inv(L)
    assert ops.tri_inv(L) is first and ops.inverse_builds == 1
    assert first.is_contiguous()
    torch.testing.assert_close(first @ L, torch.eye(40, dtype=L.dtype),
                               rtol=0, atol=1e-12)


def test_tri_inv_rebuilds_for_a_new_factor_or_an_in_place_edit():
    ops.reset_counts()
    L = _factor(40)
    first = ops.tri_inv(L)
    other = ops.tri_inv(L.clone())
    assert other is not first and ops.inverse_builds == 2
    torch.testing.assert_close(other, first, rtol=0, atol=0)
    L.mul_(2.0)
    again = ops.tri_inv(L)
    assert again is not first and ops.inverse_builds == 3
    torch.testing.assert_close(again, first / 2.0, rtol=0, atol=1e-15)


def test_tri_inv_forgets_a_freed_factor():
    L = _factor(40)
    key = id(L)
    ops.tri_inv(L)
    assert key in ops._INVERSES
    del L
    gc.collect()
    assert key not in ops._INVERSES
