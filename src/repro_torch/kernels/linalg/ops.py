"""Launch wrapper of the Cholesky downdate kernel (``csrc/chol_downdate.cu``).

The reference has no Pallas kernel here: its rank-b downdate is
``repro.core.linalg.chol_update_rank(L, W, sign=-1.0)``, LINPACK sweeps
under ``jit``. The port's kernel runs the same sweeps as a wavefront of
n + b - 1 dependent steps in one cooperative launch (see the source).

``chol_downdate`` takes the plain version (``ref.py``) for CPU tensors, and
only because they lie on the CPU. For CUDA tensors it checks dtype and
shape, launches the kernel on the current stream and raises if the launch
failed; it never falls back. ``chol_downdate_launches`` counts kernel
launches (never the plain path). The kernel has no backward: given tensors
that require grad, in grad mode, the wrapper raises
(``build.refuse_grad``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.linalg import ref

chol_downdate_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_CHUNK = 256              # rows a task of the kernel updates (CH in the source)
_INT_MAX = 2 ** 31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_counts() -> None:
    global chol_downdate_launches
    chol_downdate_launches = 0


@functools.cache
def _entry():
    lib = build.library("chol_downdate")
    fn = lib.chol_downdate
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    probe = lib.chol_downdate_barrier_probe
    probe.argtypes = [_I, _P, _P]
    probe.restype = _I
    return lib, fn, probe


def chol_downdate(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of L Lᵀ − W Wᵀ for lower L (n, n) and W (n, b),
    float32 or float64: the reference's sweeps chained over W's columns,
    with its max(·, tiny) clamp (see ``ref.chol_downdate``). L and W are
    not modified; the result is a new contiguous tensor. Zero columns of W
    leave L as it is."""
    global chol_downdate_launches
    if build.on_cpu(L, W):
        return ref.chol_downdate(L, W)
    build.refuse_grad("chol_downdate", L, W)
    if L.dtype not in _DTYPE_CODE or W.dtype != L.dtype:
        raise TypeError(f"the downdate kernel takes float32 or float64 L and "
                        f"W of one dtype; got {L.dtype}, {W.dtype}")
    if L.ndim != 2 or L.shape[0] != L.shape[1] or W.ndim != 2 \
            or W.shape[0] != L.shape[0]:
        raise ValueError(f"need L (n, n) and W (n, b); got "
                         f"{tuple(L.shape)}, {tuple(W.shape)}")
    n, b = W.shape
    if n == 0 or b == 0:
        return L.clone(memory_format=torch.contiguous_format)
    if n + b > _INT_MAX or min(n, b) * -(-n // _CHUNK) > _INT_MAX:
        raise ValueError(f"(n, b) = ({n}, {b}) exceeds the kernel's int "
                         f"indexing")
    # transposed copies: the kernel updates Lt in place and uses Wt as
    # scratch, so clone always copies (a transposed view of a contiguous
    # tensor is already contiguous and would otherwise be written through)
    Lt = L.mT.clone(memory_format=torch.contiguous_format)
    Wt = W.mT.clone(memory_format=torch.contiguous_format)
    dg = torch.diagonal(L).repeat(2)
    sync = torch.zeros(1, dtype=torch.int32, device=L.device)
    lib, fn, _ = _entry()
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        code = fn(_DTYPE_CODE[L.dtype], Lt.data_ptr(), Wt.data_ptr(),
                  dg.data_ptr(), sync.data_ptr(), n, b, stream)
    build.check(lib, code, "chol_downdate launch")
    chol_downdate_launches += 1
    return Lt.mT.contiguous()


def barrier_probe(steps: int, device) -> None:
    """Launch ``steps`` empty grid barriers on the grid ``chol_downdate``
    uses (its floor of n + b - 1 barriers, for timing); not counted as a
    launch of the kernel."""
    lib, _, probe = _entry()
    sync = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(sync.device):
        stream = torch.cuda.current_stream(sync.device).cuda_stream
        code = probe(steps, sync.data_ptr(), stream)
    build.check(lib, code, "chol_downdate barrier probe")
