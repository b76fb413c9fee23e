"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
with that reason elsewhere; run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks at the main path's full shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rbf import ops, ref

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
    """The 8-, 16- and 32-row query tiles change the grid, not the numbers
    (float64, so the sums agree to rounding)."""
    rng = np.random.default_rng(5)
    Xq = torch.tensor(rng.normal(size=(64, 5))).to(cuda)
    Xk = torch.tensor(rng.normal(size=(40, 5))).to(cuda)
    L1, L2, alpha = _factors(40, torch.float64, cuda)
    want = ops.xcov_diag(Xq, Xk, L1, alpha, 0.9, L2, block_q=32)
    for bq in (8, 16):
        got = ops.xcov_diag(Xq, Xk, L1, alpha, 0.9, L2, block_q=bq)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) < 1e-12


def test_xcov_kernel_rejects_bfloat16(cuda):
    X = torch.zeros(4, 2, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.xcov_diag(X, X, torch.eye(4, device=cuda), torch.zeros(4,
                      device=cuda), 1.0)
