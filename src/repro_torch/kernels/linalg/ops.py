"""Launch wrappers of the linear-algebra kernels: the Cholesky downdate
(``csrc/chol_downdate.cu``) and the fixed-order row products of pPIC's
serving diag (``csrc/row_products.cu``: ``rows_mm``, ``rows_reduce``).

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

``rows_mm`` and ``rows_reduce`` follow the same rules (the plain versions
for CPU and meta tensors, the kernel or an error for CUDA tensors,
``refuse_grad``), and count their launches in ``rows_mm_launches`` and
``rows_reduce_launches``. The reference computes their program in jnp under
``jit`` (``src/repro/core/ppic.py:141-167``); see the source for why the
port's order of summation is part of the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.linalg import ref

chol_downdate_launches = 0
rows_mm_launches = 0
rows_reduce_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_INT_MAX = 2 ** 31 - 1
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROWS_BLOCK = 32          # row_products.cu's BM64: rows a float64 block
_GRID_MAX = 65535         # grid.y and grid.z
ROWS_QN = 32              # row_products.cu's QN: query rows a tile (N)
ROWS_PM = 64              # its PM: output columns a panel (M)
ROWS_QT_MAX = 6           # query tiles a float32 block (row_products.cu's
                          # launch_f32_qt: 1 with one warpgroup, else two)
ROWS_KMAJ, ROWS_NMAJ, ROWS_ANY = 0, 1, 2   # its Layout
ROWS_PANEL_MAJOR_BYTES = 16 << 20   # queries that stay in L2 (50 MB) for a
                                    # wave of panel ranks


def reset_counts() -> None:
    global chol_downdate_launches, rows_mm_launches, rows_reduce_launches
    chol_downdate_launches = rows_mm_launches = rows_reduce_launches = 0


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


# --- row_products.cu ---------------------------------------------------------

@functools.cache
def _rows_entry():
    """The row products' library and its two entries."""
    lib = build.library("row_products")
    lib.rows_mm.argtypes = [_I, _P, _P, _P, _LL, _LL, _LL, _LL, _P, _P, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.rows_reduce.argtypes = [_I, _LL, _I, _I, _I] + [_P] * 6 + [_LL] \
        + [_P, _P, _I, _P, _P, _P, _P]
    for fn in (lib.rows_mm, lib.rows_reduce):
        fn.restype = _I
    return lib, lib.rows_mm, lib.rows_reduce


def _float_dtype(what: str, *tensors) -> torch.dtype:
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what} takes float32 or float64 tensors of one "
                        f"dtype; got {[t.dtype for t in tensors]}")
    return dt


def _table_index(idx: torch.Tensor | None, nblk: int, table: torch.Tensor,
                 what: str) -> torch.Tensor | None:
    """Check a block's entries of a per-state table: ``idx`` (nblk,) int64
    into its leading axis, or None for block k reading entry k."""
    if idx is None:
        if table.shape[0] != nblk:
            raise ValueError(f"{what}: {nblk} blocks and a table of "
                             f"{table.shape[0]} entries need an index")
        return None
    if idx.dtype != torch.int64 or idx.shape != (nblk,):
        raise ValueError(f"{what}: idx must be ({nblk},) int64; got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    return idx.contiguous()


class RowsPlan(NamedTuple):
    """How a float32 ``rows_mm`` launch tiles its work (``rows_plan``)."""
    qt: int             # query tiles of ROWS_QN rows a kernel block
    layout: int         # the table's staging: ROWS_KMAJ, ROWS_NMAJ, ROWS_ANY
    panel_major: bool   # blocks numbered by panel rank before table block


def rows_plan(shape: tuple, B: torch.Tensor, trans: bool = False,
              lower: bool = False) -> RowsPlan:
    """The tiling of a float32 ``rows_mm`` launch over X of ``shape``
    (nblk, u, K) and the table (or shared matrix) B, read as op(B_e) =
    B_eᵀ with ``trans``. None of it changes a row's arithmetic.

    qt: the query tiles of ROWS_QN rows a kernel block takes, at most
    ROWS_QT_MAX: the fewest blocks for each table panel, their tiles
    balanced (u = 336: 11 tiles, 2 blocks of qt = 6). A block of one tile
    has one warpgroup and ROWS_PM output columns, a larger one two
    warpgroups and twice the columns.

    layout: how a panel of op(B_e) is staged, ROWS_KMAJ (k-contiguous,
    16-byte copies along k) or ROWS_NMAJ (n-contiguous, along n) where the
    other stride and every entry's start are whole 16 bytes, else ROWS_ANY
    (one element a copy).

    panel_major: with ``lower`` the panels' k ranges differ up to K / 64
    fold; numbered by panel rank first (longest first, over all table
    blocks) only short panels are left for the tail. Every wave of ranks
    then reads all blocks' queries again, so only where they fit in
    ROWS_PANEL_MAJOR_BYTES."""
    nblk, u, K = shape
    tiles = max(1, -(-u // ROWS_QN))
    blocks = -(-tiles // ROWS_QT_MAX)
    qt = -(-tiles // blocks)
    sp, sq = B.stride()[-2:]
    sk, sn = (sq, sp) if trans else (sp, sq)
    bstride = B.stride(0) if B.ndim == 3 else 0
    base = B.data_ptr() % 16 == 0 and bstride % 4 == 0
    if base and sk == 1 and sn % 4 == 0:
        layout = ROWS_KMAJ
    elif base and sn == 1 and sk % 4 == 0:
        layout = ROWS_NMAJ
    else:
        layout = ROWS_ANY
    panel_major = lower and 4 * nblk * u * K <= ROWS_PANEL_MAJOR_BYTES
    return RowsPlan(qt, layout, panel_major)


def rows_mm(X: torch.Tensor, B: torch.Tensor, idx: torch.Tensor | None = None,
            *, trans: bool = False, lower: bool = False,
            C0: torch.Tensor | None = None) -> torch.Tensor:
    """Y[k] = X[k] op(B_e), or C0[k] - X[k] op(B_e) where C0 is given, for
    X (nblk, u, K), float32 or float64: B_e is B (P, Q) for every block, or
    entry idx[k] (or k where idx is None) of a table B (nt, P, Q); op(B_e)
    = B_eᵀ with ``trans``; ``lower`` says B_e is lower triangular. Returns
    a new (nblk, u, N) tensor. Every output element is summed over K in the
    same order whatever u, nblk, the row's slot or the other blocks
    (``ref.rows_mm``). B is read in place through its strides. On the card
    an index outside the table gives NaN rows (checking it here would wait
    for the device)."""
    global rows_mm_launches
    given = [t for t in (X, B, idx, C0) if t is not None]
    if build.on_cpu(*given):
        return ref.rows_mm(X, B, idx, trans=trans, lower=lower, C0=C0)
    build.refuse_grad("rows_mm", X, B, C0)
    dt = _float_dtype("rows_mm", *(t for t in (X, B, C0) if t is not None))
    if X.ndim != 3 or B.ndim not in (2, 3):
        raise ValueError(f"need X (nblk, u, K) and B (P, Q) or (nt, P, Q); "
                         f"got {tuple(X.shape)}, {tuple(B.shape)}")
    nblk, u, K = X.shape
    P, Q = B.shape[-2:]
    N = P if trans else Q
    if (Q if trans else P) != K or (lower and P != Q):
        raise ValueError(f"op(B) of B {tuple(B.shape)} (trans={trans}, "
                         f"lower={lower}) does not take X's K = {K}")
    if B.ndim == 2 and idx is not None:
        raise ValueError("rows_mm: an index needs a table B (nt, P, Q)")
    if B.ndim == 3:
        idx = _table_index(idx, nblk, B, "rows_mm")
    if C0 is not None and C0.shape != (nblk, u, N):
        raise ValueError(f"C0 must be {(nblk, u, N)}; got {tuple(C0.shape)}")
    # B is read in place through its strides (a table is never copied)
    bstride = 0 if B.ndim == 2 else B.stride(0)
    sp, sq = B.stride()[-2:]
    plan = rows_plan(X.shape, B, trans, lower)
    if dt == torch.float64:
        over = nblk > _GRID_MAX or -(-u // _ROWS_BLOCK) > _GRID_MAX
    else:
        cols = ROWS_PM * (1 if plan.qt == 1 else 2)
        over = nblk * -(-N // cols) * -(-u // (ROWS_QN * plan.qt)) > _INT_MAX
    if over:
        raise ValueError(f"rows_mm: {nblk} blocks of {u} rows exceed the "
                         f"kernel's grid")
    Y = torch.empty((nblk, u, N), dtype=dt, device=X.device)
    if Y.numel() == 0:
        return Y
    if K == 0:
        return Y.zero_() if C0 is None else Y.copy_(C0)
    X = X.contiguous()
    C0 = None if C0 is None else C0.contiguous()
    lib, entry, _ = _rows_entry()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        code = entry(_DTYPE_CODE[dt], X.data_ptr(), B.data_ptr(),
                     None if idx is None else idx.data_ptr(),
                     1 if B.ndim == 2 else B.shape[0], bstride, sp, sq,
                     None if C0 is None else C0.data_ptr(), Y.data_ptr(),
                     nblk, u, K, N, int(trans), int(lower), plan.qt,
                     plan.layout, int(plan.panel_major), stream)
    build.check(lib, code, "rows_mm launch")
    rows_mm_launches += 1
    return Y


def rows_reduce(kdiag: torch.Tensor, Phi: torch.Tensor, alpha: torch.Tensor,
                R: torch.Tensor, Wy: torch.Tensor, idx: torch.Tensor | None,
                A: torch.Tensor, V: torch.Tensor, Z: torch.Tensor, *,
                cinv: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) (nblk, u) of eqs. (12)-(13): mean = Phi.alpha + R.Wy_e,
    var = ((kdiag - |A|²) - |V|²) + |Z|², R.V in place of |V|² where
    ``cinv``; Phi, A, Z (nblk, u, s), R, V (nblk, u, b), alpha (s,), Wy a
    table (nt, b) read at idx[k] (or k), kdiag (nblk, u). One launch; each
    row's sums in a fixed order (``ref.rows_reduce``). An index outside
    the table gives NaN rows, as in ``rows_mm``."""
    global rows_reduce_launches
    given = [t for t in (kdiag, Phi, alpha, R, Wy, idx, A, V, Z)
             if t is not None]
    if build.on_cpu(*given):
        return ref.rows_reduce(kdiag, Phi, alpha, R, Wy, idx, A, V, Z,
                               cinv=cinv)
    build.refuse_grad("rows_reduce", kdiag, Phi, alpha, R, Wy, A, V, Z)
    dt = _float_dtype("rows_reduce", kdiag, Phi, alpha, R, Wy, A, V, Z)
    nblk, u, s = Phi.shape
    b = R.shape[-1]
    if not (kdiag.shape == (nblk, u) and A.shape == Z.shape == Phi.shape
            and R.shape == V.shape == (nblk, u, b) and alpha.shape == (s,)
            and Wy.ndim == 2 and Wy.shape[1] == b):
        raise ValueError(
            f"rows_reduce shapes: kdiag {tuple(kdiag.shape)}, Phi/A/Z "
            f"{tuple(Phi.shape)}/{tuple(A.shape)}/{tuple(Z.shape)}, R/V "
            f"{tuple(R.shape)}/{tuple(V.shape)}, alpha {tuple(alpha.shape)}, "
            f"Wy {tuple(Wy.shape)}")
    idx = _table_index(idx, nblk, Wy, "rows_reduce")
    mean = torch.empty((nblk, u), dtype=dt, device=Phi.device)
    var = torch.empty_like(mean)
    if mean.numel() == 0:
        return mean, var
    ts = [t.contiguous() for t in (kdiag, Phi, alpha, R, Wy, A, V, Z)]
    kd, ph, al, r, w, a, v, z = ts
    lib, _, entry = _rows_entry()
    with torch.cuda.device(Phi.device):
        stream = torch.cuda.current_stream(Phi.device).cuda_stream
        code = entry(_DTYPE_CODE[dt], nblk * u, u, s, b, kd.data_ptr(),
                     ph.data_ptr(), al.data_ptr(), r.data_ptr(),
                     w.data_ptr(), None if idx is None else idx.data_ptr(),
                     Wy.shape[0], a.data_ptr(), v.data_ptr(), int(cinv), z.data_ptr(),
                     mean.data_ptr(), var.data_ptr(), stream)
    build.check(lib, code, "rows_reduce launch")
    rows_reduce_launches += 1
    return mean, var
