"""The port's SSD (``repro_torch.kernels.ssd`` and ``models.ssm.ssd_scan``)
on the CPU, where ``ops.intra_chunk`` takes its plain version, against the
JAX package's Pallas intra-chunk kernel in interpret mode and its chunked
jnp scan, on the reference's shapes (tests/test_ssd_kernel.py). Inputs are
made with numpy from a seed and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd.ssd import ssd_intra_chunk
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import ops
from repro_torch.models import ssm

# The reference's own tolerances (tests/test_ssd_kernel.py): 3e-4 for Y and
# S, 1e-5 for cum, 2e-4 for the full scan against the chunked jnp scan.
TOL_YS, TOL_CUM, TOL_SCAN = 3e-4, 1e-5, 2e-4


def _intra_inputs(BC, cs, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BC, cs, H, P)).astype(np.float32),
            (-np.abs(rng.normal(size=(BC, H, cs))) * 0.1).astype(np.float32),
            rng.normal(size=(BC, cs, N)).astype(np.float32),
            rng.normal(size=(BC, cs, N)).astype(np.float32))


def _scan_inputs(B, L, H, P, N, seed=1):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, L, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, L, H))))      # softplus
    A = -np.exp(rng.normal(size=(H,)) * 0.3)
    Bm = rng.normal(size=(B, L, N))
    Cm = rng.normal(size=(B, L, N))
    return [a.astype(np.float32) for a in (xh, dt, A, Bm, Cm)]


def _close(got: torch.Tensor, want, tol):
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
    err = float(np.abs(got.numpy() - w).max())
    assert err < tol, err


@pytest.mark.parametrize("BC,cs,H,P,N", [(4, 16, 3, 8, 8), (2, 64, 2, 16, 16),
                                         (1, 128, 1, 64, 128),
                                         (3, 32, 4, 8, 32), (2, 20, 3, 5, 7)])
def test_intra_chunk_matches_pallas(BC, cs, H, P, N):
    arrs = _intra_inputs(BC, cs, H, P, N)
    ops.reset_counts()
    got = ops.intra_chunk(*(torch.tensor(a) for a in arrs))
    assert ops.ssd_launches == 0            # CPU tensors: the plain path
    want = ssd_intra_chunk(*(jnp.asarray(a) for a in arrs), interpret=True)
    for g, w, tol in zip(got, want, (TOL_YS, TOL_YS, TOL_CUM)):
        _close(g, w, tol)


def test_intra_chunk_bf16_inputs_compute_in_f32():
    arrs = _intra_inputs(2, 32, 2, 8, 16)
    got = ops.intra_chunk(*(torch.tensor(a).to(torch.bfloat16)
                            for a in arrs))
    want = ssd_intra_chunk(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                           interpret=True)
    for g, w, tol in zip(got, want, (TOL_YS, TOL_YS, TOL_CUM)):
        _close(g, w, tol)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_scan_matches_pallas_and_reference(chunk):
    arrs = _scan_inputs(2, 64, 3, 8, 16)
    targs = [torch.tensor(a) for a in arrs]
    jargs = [jnp.asarray(a) for a in arrs]
    Y, final = ops.ssd_scan(*targs, chunk)
    for Yw, fw in (jssd_ops.ssd_scan(*jargs, chunk, impl="pallas_interpret"),
                   jssm.ssd_scan(*jargs, chunk)):
        _close(Y, Yw, TOL_SCAN)
        _close(final, fw, TOL_SCAN)
    # the port's own chunked plain reference of the whole scan
    Yp, fp = ssm.ssd_scan(*targs, chunk)
    _close(Yp, jssm.ssd_scan(*jargs, chunk)[0], TOL_SCAN)
    _close(fp, jssm.ssd_scan(*jargs, chunk)[1], TOL_SCAN)


def test_ssd_scan_matches_recurrence():
    """The chunked scan equals the naive sequential recurrence."""
    xh, dt, A, Bm, Cm = (torch.tensor(a).double()
                         for a in _scan_inputs(2, 32, 3, 4, 8))
    Y, final = ops.ssd_scan(xh, dt, A, Bm, Cm, 8)
    S = torch.zeros(2, 3, 4, 8, dtype=torch.float64)
    outs = []
    for t in range(32):
        dA = torch.exp(dt[:, t] * A)
        upd = (dt[:, t, :, None] * xh[:, t])[..., None] \
            * Bm[:, t, None, None, :]
        S = S * dA[..., None, None] + upd
        outs.append(torch.einsum("bhpn,bn->bhp", S, Cm[:, t]))
    assert float((Y.double() - torch.stack(outs, 1)).abs().max()) < 2e-4
    assert float((final.double() - S).abs().max()) < 2e-4


def test_ssd_scan_rejects_a_ragged_sequence():
    xh, dt, A, Bm, Cm = (torch.tensor(a) for a in _scan_inputs(1, 12, 2, 4, 4))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(xh, dt, A, Bm, Cm, 8)


# --- why the CUDA kernel's products run in 3xTF32 -----------------------------

def _tf32(x: torch.Tensor, nearest: bool) -> torch.Tensor:
    """x on a 10-bit mantissa (TF32), in float64: rounded to nearest, ties
    away from zero (cvt.rna.tf32.f32, a TF32 matmul's conversion), or
    truncated (what the tensor core reads of a float32 register)."""
    m, e = torch.frexp(x)                       # x = m 2^e, 0.5 <= |m| < 1
    scaled = m.abs() * 2.0 ** 11
    kept = torch.floor(scaled + 0.5) if nearest else torch.floor(scaled)
    return torch.ldexp(torch.sign(m) * kept / 2.0 ** 11, e)


def _one_tf32(a, b):
    return _tf32(a, True) @ _tf32(b, True)


def _three_tf32(a, b):
    """The kernel's split: hi = x as the tensor core reads it, lo the
    exact remainder, read the same way; hi hi' + lo hi' + hi lo'."""
    ah, bh = _tf32(a, False), _tf32(b, False)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return ah @ bh + al @ bh + ah @ bl


def _intra_products(xdt, dA, Bc, Cc, prod):
    """The plain version's three products, each through ``prod``, in
    float64: G = C B^T, Y = (G o L) xdt, S = (xdt o decay)^T B."""
    cs = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)                          # (BC, H, cs)
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool))
    seg = cum[..., :, None] - cum[..., None, :]
    L = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    G = prod(Cc, Bc.transpose(1, 2))                        # (BC, cs, cs)
    x = xdt.permute(0, 2, 1, 3)                             # (BC, H, cs, P)
    Y = prod(G[:, None] * L, x)                             # (BC, H, cs, P)
    decay = torch.exp(cum[..., -1:] - cum)                  # (BC, H, cs)
    S = prod((x * decay[..., None]).transpose(2, 3), Bc[:, None])
    return Y, S


def test_3xtf32_meets_the_reference_tolerance_and_tf32_does_not():
    """At two chunks of the mamba2-130m prefill shape, the kernel's 3xTF32
    products stay within the tolerance the card holds the kernel to
    (chip_smoke.py's ssd_tol: 3e-4, relative 3e-5 above |out| = 10) of the
    exact float64 result; a single TF32 product misses it."""
    arrs = _intra_inputs(2, 256, 24, 64, 128, seed=4)
    xdt, dA, Bc, Cc = (torch.tensor(a, dtype=torch.float64) for a in arrs)
    exact = _intra_products(xdt, dA, Bc, Cc, torch.matmul)
    three = _intra_products(xdt, dA, Bc, Cc, _three_tf32)
    one = _intra_products(xdt, dA, Bc, Cc, _one_tf32)
    for want, got3, got1 in zip(exact, three, one):
        tol = TOL_YS * max(1.0, float(want.abs().max()) / 10.0)
        assert float((got3 - want).abs().max()) < tol / 10
        assert float((got1 - want).abs().max()) > tol
