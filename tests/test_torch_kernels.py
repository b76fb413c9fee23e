"""The port's rbf/xcov_diag plain versions and launch wrappers, on the CPU,
against the JAX package's oracles (``repro.kernels.rbf.ref``) and its Pallas
kernels in interpret mode, on the reference's shape ladders and tolerances
(tests/test_kernels.py, tests/test_xcov_fused.py). Inputs are made with
numpy from a seed and fed to both packages."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbf import ops as jops, ref as jref
from repro_torch.kernels.rbf import ops, ref

RBF_SHAPES = [(64, 96, 3), (200, 130, 21), (256, 256, 5), (33, 17, 7),
              (128, 128, 128), (8, 300, 1)]
RBF_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
XCOV_TOL = {"float32": 1e-5, "float64": 1e-10}
XCOV_SHAPES = [(s, d) for s, d in ((12, 3), (128, 8), (130, 21))]
XCOV_N = [1, 8, 16, 33, 64, 128, 200, 256]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU torch tensor of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.tensor(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x.astype(jnp.float64))


def _factors(s: int, seed: int = 0):
    """Well-conditioned Cholesky factors and weights (as the reference's
    fused-kernel tests build them), in float64 numpy."""
    rng = np.random.default_rng(seed)
    A1, A2 = rng.normal(size=(s, s)), rng.normal(size=(s, s))
    L1 = np.linalg.cholesky(A1 @ A1.T + s * np.eye(s))
    L2 = np.linalg.cholesky(A2 @ A2.T + 2 * s * np.eye(s))
    return L1, L2, rng.normal(size=(s,))


@pytest.mark.parametrize("n,m,d", RBF_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rbf_plain_matches_jax_oracle_and_pallas(n, m, d, dtype):
    rng = np.random.default_rng(n * m + d)
    jq, tq = _pair(rng.normal(size=(n, d)).astype(np.float32), dtype)
    jk, tk = _pair(rng.normal(size=(m, d)).astype(np.float32), dtype)
    got = ops.rbf_covariance(tq, tk, 1.7)          # CPU tensors: plain path
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, m)
    for want in (jref.rbf_covariance(jq, jk, 1.7),
                 jops.rbf_covariance(jq, jk, 1.7, impl="pallas_interpret")):
        assert np.abs(_np(got) - _np(want)).max() < RBF_TOL[dtype]


def test_rbf_batched_matches_per_machine_oracle():
    """A 2-D operand broadcasts over the machine axis (K_{S,D_m}), and two
    3-D operands pair up (K_{D_m,D_m}), as vmap over the kernel did. The
    plain version accumulates in float32 (the kernel's contract), so the
    batched and per-machine products agree to float32 rounding."""
    rng = np.random.default_rng(3)
    S = rng.normal(size=(12, 3))
    Xb = rng.normal(size=(4, 9, 3))
    ksd = ops.rbf_covariance(torch.tensor(S), torch.tensor(Xb), 1.3)
    kdd = ops.rbf_covariance(torch.tensor(Xb), torch.tensor(Xb), 1.3)
    assert ksd.shape == (4, 12, 9) and kdd.shape == (4, 9, 9)
    for m in range(4):
        want_sd = jref.rbf_covariance(jnp.asarray(S), jnp.asarray(Xb[m]), 1.3)
        want_dd = jref.rbf_covariance(jnp.asarray(Xb[m]), jnp.asarray(Xb[m]),
                                      1.3)
        assert np.abs(_np(ksd[m]) - _np(want_sd)).max() < 1e-6
        assert np.abs(_np(kdd[m]) - _np(want_dd)).max() < 1e-6


@pytest.mark.parametrize("sq,sk", [((1, 5), (4, 40, 5)), ((33, 7), (17, 7)),
                                   ((4, 9, 3), (4, 9, 3))])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-14)])
def test_rbf_exact_plain_is_the_se_kernel_in_its_dtype(sq, sk, dtype, tol):
    """The exact instance's plain version (what a CPU tensor takes)
    computes in the inputs' dtype: against sig2 exp(-|x - z|^2 / 2) from
    numpy's float64 differences, and the JAX oracle's float32 sum only to
    float32 rounding."""
    rng = np.random.default_rng(len(sq) * 7 + sk[-2])
    q, k = rng.normal(size=sq), rng.normal(size=sk)
    ops.reset_counts()
    got = ops.rbf_covariance_exact(torch.tensor(q).to(getattr(torch, dtype)),
                                   torch.tensor(k).to(getattr(torch, dtype)),
                                   1.7)
    assert ops.rbf_exact_launches == 0
    assert got.dtype == getattr(torch, dtype)
    diff = q[..., :, None, :] - k[..., None, :, :]
    want = 1.7 * np.exp(-0.5 * np.sum(diff * diff, -1))
    assert got.shape == want.shape
    assert np.abs(_np(got) - want).max() < tol


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    ops.reset_counts()
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(10, 3)))
    L1, L2, alpha = (torch.tensor(a) for a in _factors(10))
    k = ops.rbf_covariance(X, X, 1.0)
    m, v = ops.xcov_diag(X, X, L1, alpha, 1.0, L2)
    torch.testing.assert_close(k, ref.rbf_covariance(X, X, 1.0), rtol=0,
                               atol=0)
    m_r, v_r = ref.xcov_diag(X, X, L1, alpha, 1.0, L2)
    torch.testing.assert_close((m, v), (m_r, v_r), rtol=0, atol=0)
    assert (ops.rbf_launches, ops.xcov_launches) == (0, 0)


def test_wrappers_reject_mixed_devices():
    X = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="all lie on the CPU"):
        ops.rbf_covariance(X, X.to("meta"), 1.0)


def test_xcov_diag_inv_is_the_kernel_only():
    X = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.xcov_diag_inv(X, X, torch.eye(4), torch.zeros(4), 1.0)


@functools.cache
def _xcov_oracle(s: int, d: int, dtype: str):
    """Inputs for the top of the query ladder, and the JAX oracle's (mean,
    var) with and without L2 on them. Query rows are independent, so a
    smaller batch is checked against the oracle's leading rows (one JAX
    compile per case instead of one per batch size)."""
    rng = np.random.default_rng(s + d)
    Xq = rng.normal(size=(max(XCOV_N), d))
    Xk = rng.normal(size=(s, d))
    L1, L2, alpha = _factors(s)
    j = [_pair(a, dtype)[0] for a in (Xq, Xk, L1, L2, alpha)]
    want = {l2: [_np(o) for o in jref.xcov_diag(j[0], j[1], j[2], j[4], 1.3,
                                                j[3] if l2 else None)]
            for l2 in (True, False)}
    return (Xq, Xk, L1, L2, alpha), want


@pytest.mark.parametrize("n", XCOV_N)
@pytest.mark.parametrize("s,d", XCOV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xcov_plain_matches_jax_oracle(n, s, d, dtype):
    arrays, want = _xcov_oracle(s, d, dtype)
    tq, tk, tL1, tL2, ta = (_pair(a, dtype)[1] for a in arrays)
    for with_l2 in (True, False):
        got = ops.xcov_diag(tq[:n], tk, tL1, ta, 1.3,
                            tL2 if with_l2 else None)
        for g, w in zip(got, want[with_l2]):
            assert g.dtype == getattr(torch, dtype) and g.shape == (n,)
            assert np.abs(_np(g) - w[:n]).max() <= XCOV_TOL[dtype]


@pytest.mark.parametrize("n", [1, 33, 256])
@pytest.mark.parametrize("s,d", [(12, 3), (130, 21)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xcov_plain_matches_jax_pallas_interpret(n, s, d, dtype):
    rng = np.random.default_rng(7 * n + s)
    jq, tq = _pair(rng.normal(size=(n, d)), dtype)
    jk, tk = _pair(rng.normal(size=(s, d)), dtype)
    (jL1, tL1), (jL2, tL2), (ja, ta) = (_pair(a, dtype)
                                        for a in _factors(s, seed=1))
    want = jops.xcov_diag(jq, jk, jL1, ja, 0.9, jL2, impl="pallas_interpret")
    got = ops.xcov_diag(tq, tk, tL1, ta, 0.9, tL2)
    for g, w in zip(got, want):
        assert np.abs(_np(g) - _np(w)).max() <= XCOV_TOL[dtype]


@pytest.mark.parametrize("s,s_pad", [(12, 12), (12, 16), (130, 256)])
def test_embed_tri_inv_matches_reference(s, s_pad):
    L1, _, _ = _factors(s)
    got = ops._embed_tri_inv(torch.tensor(L1), s_pad)
    want = jops._embed_tri_inv(jnp.asarray(L1), s_pad)
    assert got.shape == (s_pad, s_pad)
    assert np.abs(_np(got) - _np(want)).max() < 1e-12


def test_pick_serve_block_q_matches_reference():
    assert [ops.pick_serve_block_q(n) for n in range(0, 600)] == \
        [jops.pick_serve_block_q(n) for n in range(0, 600)]


@pytest.mark.parametrize("n,block_q,tile", [
    (1, None, (8, 8)), (15, None, (8, 8)), (16, None, (16, 16)),
    (31, None, (16, 16)), (32, None, (32, 32)), (3200, None, (64, 32)),
    (100, 24, (16, 16)), (100, 4, (8, 8)), (100, 64, (64, 32))])
def test_kernel_query_tile(n, block_q, tile):
    """The serving tile (reference rule) picks the largest of the kernel's
    query tiles not above it: 64/32/16/8 rows for the float32 tensor-core
    kernel, 32/16/8 for the float64 one."""
    assert (ops._kernel_tile(n, block_q, torch.float32),
            ops._kernel_tile(n, block_q, torch.float64)) == tile
