"""Launch wrappers of the rbf CUDA kernels — port of
``repro.kernels.rbf.ops``.

Each wrapper takes its kernel's plain version (``ref.py``) for CPU tensors,
and only because they lie on the CPU. For CUDA tensors it checks device,
dtype, shape and contiguity, allocates the outputs, launches the kernel on
the current stream and raises if the launch failed; it never falls back.
``rbf_launches`` / ``xcov_launches`` count kernel launches (never the plain
path), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rbf import ref

rbf_launches = 0
xcov_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_GRID_Y_MAX = 65535
_RBF_BLOCK_M = 64         # output rows per block of rbf.cu
_XCOV_TILES = (32, 16, 8)  # query tiles xcov_diag.cu is instantiated for
_XCOV_PANEL = 64           # columns of V per block of xcov_diag.cu (BJ)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_counts() -> None:
    global rbf_launches, xcov_launches
    rbf_launches = xcov_launches = 0


@functools.cache
def _rbf_entry():
    lib = build.library("rbf")
    fn = lib.rbf_covariance
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P]
    fn.restype = _I
    return lib, fn


@functools.cache
def _xcov_entry():
    lib = build.library("xcov_diag")
    fn = lib.xcov_diag
    fn.argtypes = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def _check_cuda(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: dtype {t.dtype} not supported by the "
                            f"CUDA kernel; have {list(_DTYPE_CODE)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rbf_covariance(Xq: torch.Tensor, Xk: torch.Tensor, sig2) -> torch.Tensor:
    """sig2 * exp(-0.5 ||x - z||^2) over pre-scaled inputs.

    Xq: (n, d) or (B, n, d); Xk: (m, d) or (B, m, d) -> (n, m) or (B, n, m).
    A 2-D operand is shared by every batch entry (batch stride 0), so
    ``rbf_covariance(S, Xb)`` builds K_{S,D_m} for all machines in one
    launch. f32/bf16/f64 in, f32 accumulation, output in Xq's dtype.
    """
    global rbf_launches
    if build.on_cpu(Xq, Xk):
        return ref.rbf_covariance(Xq, Xk, sig2)
    _check_cuda(Xq=Xq, Xk=Xk)
    if Xq.dtype != Xk.dtype:
        raise TypeError(f"Xq and Xk dtypes differ: {Xq.dtype} vs {Xk.dtype}")
    if Xq.ndim not in (2, 3) or Xk.ndim not in (2, 3) \
            or Xq.shape[-1] != Xk.shape[-1]:
        raise ValueError(f"need (n, d)/(B, n, d) and (m, d)/(B, m, d) with "
                         f"one d; got {tuple(Xq.shape)}, {tuple(Xk.shape)}")
    batched = Xq.ndim == 3 or Xk.ndim == 3
    if Xq.ndim == 3 and Xk.ndim == 3 and Xq.shape[0] != Xk.shape[0]:
        raise ValueError(f"batch sizes differ: {Xq.shape[0]} vs "
                         f"{Xk.shape[0]}")
    B = Xq.shape[0] if Xq.ndim == 3 else (Xk.shape[0] if batched else 1)
    n, d = Xq.shape[-2:]
    m = Xk.shape[-2]
    if -(-n // _RBF_BLOCK_M) > _GRID_Y_MAX or B > _GRID_Y_MAX:
        raise ValueError(f"n={n} or batch={B} exceeds the kernel's grid")
    out = torch.empty((B, n, m) if batched else (n, m), dtype=Xq.dtype,
                      device=Xq.device)
    if out.numel() == 0:
        return out
    sq = n * d if Xq.ndim == 3 else 0
    sk = m * d if Xk.ndim == 3 else 0
    s2 = torch.as_tensor(sig2, dtype=torch.float32).to(Xq.device).reshape(1)
    lib, fn = _rbf_entry()
    with torch.cuda.device(Xq.device):
        stream = torch.cuda.current_stream(Xq.device).cuda_stream
        code = fn(_DTYPE_CODE[Xq.dtype], Xq.data_ptr(), Xk.data_ptr(),
                  s2.data_ptr(), out.data_ptr(), B, n, m, d, sq, sk, stream)
    build.check(lib, code, "rbf_covariance launch")
    rbf_launches += 1
    return out


def pick_serve_block_q(n: int) -> int:
    """Query-tile size for the fused serving kernel at batch size n: the
    largest power of two in 16..256 not exceeding n, else 8 (the reference's
    rule; the CUDA kernel then takes the largest of its 32/16/8-row tiles
    that fits, see ``xcov_diag``)."""
    for b in (256, 128, 64, 32, 16):
        if n >= b:
            return b
    return 8


def _embed_tri_inv(L: torch.Tensor, s_pad: int) -> torch.Tensor:
    """(s, s) Cholesky factor -> (s_pad, s_pad) lower-triangular INVERSE,
    embedded in an identity. Computed with a plain triangular solve outside
    the kernel, as the reference leaves it to XLA; it is recomputed on every
    dispatch, like the reference. The CUDA kernel masks ragged panels
    itself, so ``xcov_diag`` embeds with ``s_pad = s`` (no padding)."""
    s = L.shape[0]
    eye = torch.eye(s, dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    if s == s_pad:
        return Linv
    out = torch.eye(s_pad, dtype=L.dtype, device=L.device)
    out[:s, :s] = Linv
    return out


def _kernel_tile(n: int, block_q: int | None) -> int:
    bq = block_q or pick_serve_block_q(n)
    return next((t for t in _XCOV_TILES if t <= bq), _XCOV_TILES[-1])


def xcov_diag(Xq: torch.Tensor, Xk: torch.Tensor, L1: torch.Tensor,
              alpha: torch.Tensor, sig2, L2: torch.Tensor | None = None, *,
              block_q: int | None = None):
    """Fused serving hot path over pre-scaled inputs: (mean, var) of the
    summary-method diag predict (see csrc/xcov_diag.cu) without the
    (n, |S|) round trip through device memory.

    Xq: (n, d) queries, Xk: (s, d) support/training set, L1/L2: (s, s)
    cached lower Cholesky factors (variance = sig2 - q(L1) [+ q(L2)]),
    alpha: (s,) cached weights. On the card, queries are float32 or
    float64; the support set, factors and weights are cast to their dtype,
    which is also the accumulation type (the CPU plain path also takes
    bfloat16, accumulating in float32).
    ``block_q`` is the serving tile; the kernel uses the largest of its
    32/16/8-row query tiles not above it.
    """
    args = (Xq, Xk, L1, alpha) + ((L2,) if L2 is not None else ())
    if build.on_cpu(*args):
        return ref.xcov_diag(Xq, Xk, L1, alpha, sig2, L2)
    s = Xk.shape[0]
    if L1.shape != (s, s) or (L2 is not None and L2.shape != (s, s)):
        raise ValueError(f"need (s, s) factors for s={s}; got "
                         f"{tuple(L1.shape)}"
                         + ("" if L2 is None else f", {tuple(L2.shape)}"))
    L1inv = _embed_tri_inv(L1, s)
    L2inv = _embed_tri_inv(L2, s) if L2 is not None else None
    return xcov_diag_inv(Xq, Xk, L1inv, alpha, sig2, L2inv, block_q=block_q)


def xcov_diag_inv(Xq: torch.Tensor, Xk: torch.Tensor, L1inv: torch.Tensor,
                  alpha: torch.Tensor, sig2, L2inv: torch.Tensor | None = None,
                  *, block_q: int | None = None):
    """The fused kernel alone, on the lower-triangular INVERSES of the
    cached factors (what ``xcov_diag`` passes it after ``_embed_tri_inv``);
    CUDA tensors only. Entries above the diagonal are never read."""
    global xcov_launches
    args = (Xq, Xk, L1inv, alpha) + ((L2inv,) if L2inv is not None else ())
    if build.on_cpu(*args):
        raise ValueError("xcov_diag_inv launches the CUDA kernel and takes "
                         "CUDA tensors; the plain path is xcov_diag")
    n, d = Xq.shape
    s = Xk.shape[0]
    if Xk.shape != (s, d) or L1inv.shape != (s, s) or alpha.shape != (s,) \
            or (L2inv is not None and L2inv.shape != (s, s)):
        raise ValueError(
            f"need Xq (n, d), Xk (s, d), Linv (s, s), alpha (s,); got "
            f"{tuple(Xq.shape)}, {tuple(Xk.shape)}, {tuple(L1inv.shape)}, "
            f"{tuple(alpha.shape)}"
            + ("" if L2inv is None else f", L2inv {tuple(L2inv.shape)}"))
    if block_q is not None and block_q < 1:
        raise ValueError(f"block_q must be positive; got {block_q}")
    dt = Xq.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"xcov_diag's CUDA kernel takes float32 or float64 "
                        f"queries; got {dt}")
    tile = _kernel_tile(n, block_q)
    mean = torch.empty(n, dtype=dt, device=Xq.device)
    var = torch.empty(n, dtype=dt, device=Xq.device)
    if n == 0:
        return mean, var
    if s == 0 or -(-n // tile) > _GRID_Y_MAX:
        raise ValueError(f"xcov_diag needs 0 < s and n <= "
                         f"{_GRID_Y_MAX * tile}; got s={s}, n={n}")
    with_l2 = L2inv is not None
    Xk = Xk.to(dt).contiguous()
    alpha = alpha.to(dt).contiguous()
    L1inv = L1inv.to(dt).contiguous()
    L2inv = L2inv.to(dt).contiguous() if with_l2 else L1inv
    _check_cuda(Xq=Xq, Xk=Xk, L1inv=L1inv, L2inv=L2inv, alpha=alpha)
    n_panels = -(-s // _XCOV_PANEL)
    part = torch.empty(3 * n_panels * n, dtype=dt, device=Xq.device)
    s2 = torch.as_tensor(sig2, dtype=dt).to(Xq.device).reshape(1)
    lib, fn = _xcov_entry()
    with torch.cuda.device(Xq.device):
        stream = torch.cuda.current_stream(Xq.device).cuda_stream
        code = fn(_DTYPE_CODE[dt], tile, int(with_l2),
                  Xq.data_ptr(), Xk.data_ptr(), L1inv.data_ptr(),
                  L2inv.data_ptr(), alpha.data_ptr(), s2.data_ptr(),
                  part.data_ptr(), mean.data_ptr(), var.data_ptr(),
                  n, s, d, stream)
    build.check(lib, code, "xcov_diag launch")
    xcov_launches += 1
    return mean, var
