"""Launch wrapper of the Cholesky downdate kernel (``csrc/chol_downdate.cu``).

The reference has no Pallas kernel here: its rank-b downdate is
``repro.core.linalg.chol_update_rank(L, W, sign=-1.0)``, LINPACK sweeps
under ``jit``. The port's kernel runs the same sweeps in one launch: warps
take (row tile, column tile) work items of 32 x 32 from a ticket counter,
the diagonal items compute each rotation once, and each item waits on the
tagged words its predecessors write (see the source).

``chol_downdate`` takes the plain version (``ref.py``) for CPU tensors, and
only because they lie on the CPU. For CUDA tensors it checks dtype and
shape, launches the kernel on the current stream and raises if the launch
failed; it never falls back. ``chol_downdate_launches`` counts kernel
launches (never the plain path, nor the probes). The kernel has no
backward: given tensors that require grad, in grad mode, the wrapper raises
(``build.refuse_grad``).

The probes (``chain_probe``, ``quotient_probe``) are a library of their own,
``csrc/chol_downdate_probe.cu``: the shipped kernel carries none of them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.linalg import ref

chol_downdate_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_INT_MAX = 2 ** 31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_counts() -> None:
    global chol_downdate_launches
    chol_downdate_launches = 0


@functools.cache
def _entry():
    """The kernel's library, its entry and its tile (the rows and columns
    of a work item)."""
    lib = build.library("chol_downdate")
    lib.chol_downdate.argtypes = [_I, _P, _P, _P, _P, _I, _I, _P]
    lib.chol_downdate.restype = _I
    lib.chol_downdate_tile.argtypes = []
    lib.chol_downdate_tile.restype = _I
    return lib, lib.chol_downdate, lib.chol_downdate_tile()


@functools.cache
def _probes():
    """The probes' library, its chain probe and its quotient probe."""
    lib = build.library("chol_downdate_probe")
    lib.chol_downdate_chain_probe.argtypes = [_I, _P, _P, _P, _P, _I, _I, _P]
    lib.chol_downdate_quotient_probe.argtypes = [_I, _P, _P, _P, _P, _P, _I,
                                                 _P]
    for fn in (lib.chol_downdate_chain_probe,
               lib.chol_downdate_quotient_probe):
        fn.restype = _I
    return lib, lib.chol_downdate_chain_probe, \
        lib.chol_downdate_quotient_probe


def _check(L: torch.Tensor, W: torch.Tensor) -> None:
    build.refuse_grad("chol_downdate", L, W)
    if L.dtype not in _DTYPE_CODE or W.dtype != L.dtype:
        raise TypeError(f"the downdate kernel takes float32 or float64 L and "
                        f"W of one dtype; got {L.dtype}, {W.dtype}")
    if L.ndim != 2 or L.shape[0] != L.shape[1] or W.ndim != 2 \
            or W.shape[0] != L.shape[0]:
        raise ValueError(f"need L (n, n) and W (n, b); got "
                         f"{tuple(L.shape)}, {tuple(W.shape)}")


def _tagged(W: torch.Tensor, rows: int) -> torch.Tensor:
    """Wᵀ as the kernel's tagged 64-bit words, tag 0 (the input's) in the
    high half: a float's bits in one word's low half, a double's low and
    high 32 bits in two words; zero from row n to ``rows`` (n rounded up to
    whole row tiles). Returned as the int32 halves, (b, rows, 1, 2) or
    (b, rows, 2, 2)."""
    n, b = W.shape
    half = W.mT.reshape(-1).view(torch.int32).view(b, n, -1)
    words = torch.zeros((b, rows, W.element_size() // 4, 2),
                        dtype=torch.int32, device=W.device)
    words[:, :n, :, 0] = half
    return words


def _launch(lib, entry, L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The kernel's arguments, made fresh (Wᵀ's tagged words, R and the
    ticket zeroed), and one launch of ``entry`` (of ``lib``) on them;
    returns the updated copy of L."""
    n, b = W.shape
    tile = _entry()[2]
    if n + b + tile > _INT_MAX:
        raise ValueError(f"(n, b) = ({n}, {b}) exceeds the kernel's int "
                         f"indexing")
    nt = -(-n // tile)
    out = L.clone(memory_format=torch.contiguous_format)
    Wt = _tagged(W, tile * nt)
    words = 4 if L.dtype == torch.float32 else 6
    R = torch.zeros((nt, b + tile - 1, tile, words), dtype=torch.int64,
                    device=L.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=L.device)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        code = entry(_DTYPE_CODE[L.dtype], out.data_ptr(), Wt.data_ptr(),
                     R.data_ptr(), ticket.data_ptr(), n, b, stream)
    build.check(lib, code, "chol_downdate launch")
    return out


def chol_downdate(L: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of L Lᵀ − W Wᵀ for lower L (n, n) and W (n, b),
    float32 or float64: the reference's sweeps chained over W's columns,
    with its max(·, tiny) clamp (see ``ref.chol_downdate``). L and W are
    not modified; the result is a new contiguous tensor whose strict upper
    triangle is L's. Zero columns of W leave L as it is."""
    global chol_downdate_launches
    if build.on_cpu(L, W):
        return ref.chol_downdate(L, W)
    _check(L, W)
    n, b = W.shape
    if n == 0 or b == 0:
        return L.clone(memory_format=torch.contiguous_format)
    out = _launch(*_entry()[:2], L, W)
    chol_downdate_launches += 1
    return out


def chain_probe(L: torch.Tensor, W: torch.Tensor) -> None:
    """One launch of the kernel's serial chain on CUDA tensors L (n, n) and
    W (n, b), n, b >= 1: only the diagonal items and the sub-diagonal items
    that carry the rotations between them, each waiting on the tagged words
    it reads as in ``chol_downdate``; the rest of the work does not run, so
    the result is dropped. Its time is the launch's serial floor (not
    counted as a launch of the kernel)."""
    _check(L, W)
    _launch(*_probes()[:2], L, W)


def quotient_probe(a: torch.Tensor, c: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """A row update's quotients as the kernel forms them, on CUDA tensors:
    group g is one lane's step, its 32 numerators a[g] (G, 32) over c[g]
    (G,), float32 or float64, with y = 1/c correctly rounded; the step takes
    the branch-free quotient when c and every numerator whose bit is set in
    mask[g] (G,) int32 lie in its range, else the IEEE division. Returns
    the quotients (G, 32) and, per group, whether it took the fast one."""
    if a.dtype not in _DTYPE_CODE or c.dtype != a.dtype \
            or mask.dtype != torch.int32:
        raise TypeError(f"need a and c of float32 or float64 and an int32 "
                        f"mask; got {a.dtype}, {c.dtype}, {mask.dtype}")
    groups, tile = c.shape[0], _entry()[2]
    if a.shape != (groups, tile) or mask.shape != (groups,) or groups < 1:
        raise ValueError(f"need a (G, {tile}), c (G,), mask (G,), G >= 1; "
                         f"got {tuple(a.shape)}, {tuple(c.shape)}, "
                         f"{tuple(mask.shape)}")
    a, c, mask = (t.contiguous() for t in (a, c, mask))
    q = torch.empty_like(a)
    fast = torch.empty(groups, dtype=torch.int32, device=a.device)
    lib, _, entry = _probes()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = entry(_DTYPE_CODE[a.dtype], a.data_ptr(), c.data_ptr(),
                     mask.data_ptr(), q.data_ptr(), fast.data_ptr(), groups,
                     stream)
    build.check(lib, code, "chol_downdate quotient probe")
    return q, fast.bool()
