"""Launch wrappers of the rbf CUDA kernels — port of
``repro.kernels.rbf.ops``.

Each wrapper takes its kernel's plain version (``ref.py``) for CPU tensors,
and only because they lie on the CPU. For CUDA tensors it checks device,
dtype, shape and contiguity, allocates the outputs, launches the kernel on
the current stream and raises if the launch failed; it never falls back.
``rbf_launches`` / ``rbf_exact_launches`` / ``icf_launches`` /
``xcov_launches`` count kernel launches (never the plain path), so a run can show that its main path went
through the kernels;
``xcov_tc_launches`` counts the launches of the tensor-core instance (as
the C entry reports them), and ``inverse_builds`` the triangular inverses
that ``tri_inv`` built (once per factor, see there). No kernel has a
backward: a wrapper given CUDA tensors that require grad, in grad mode,
raises (``build.refuse_grad``, also importable from here as
``refuse_grad``) rather than return a tensor cut from the graph.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import refuse_grad
from repro_torch.kernels.rbf import ref

rbf_launches = 0
rbf_exact_launches = 0
icf_launches = 0
xcov_launches = 0
xcov_tc_launches = 0
inverse_builds = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_GRID_Y_MAX = 65535
_RBF_BLOCK_M = 64         # output rows per block of rbf.cu
# query tiles xcov_diag.cu is instantiated for: the float32 tensor-core
# kernel (queries on the mma's N side) and the float64 FMA kernel
_XCOV_TILES = {torch.float32: (64, 32, 16, 8), torch.float64: (32, 16, 8)}
_XCOV_PANEL = 64          # rows of V^T (support points) per panel
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_counts() -> None:
    global rbf_launches, rbf_exact_launches, icf_launches, xcov_launches, \
        xcov_tc_launches, inverse_builds
    rbf_launches = rbf_exact_launches = icf_launches = xcov_launches = \
        xcov_tc_launches = inverse_builds = 0


@functools.cache
def _rbf_entry():
    lib = build.library("rbf")
    fn = lib.rbf_covariance
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P]
    fn.restype = _I
    exact = lib.rbf_covariance_exact
    exact.argtypes = fn.argtypes
    exact.restype = _I
    return lib, fn, exact


@functools.cache
def _icf_entry():
    lib = build.library("rbf_icf")
    fn = lib.rbf_icf
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                   _I, _P]
    fn.restype = _I
    plan = lib.rbf_icf_plan
    plan.argtypes = [_I, _I, _I, _I, _I] + [ctypes.POINTER(_I)] * 7
    plan.restype = _I
    probe = lib.rbf_icf_barrier_probe
    probe.argtypes = [_I, _I, _I, _I, _P, _P]
    probe.restype = _I
    return lib, fn, plan, probe


@functools.cache
def _xcov_entry():
    lib = build.library("xcov_diag")
    fn = lib.xcov_diag
    fn.argtypes = [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _P, ctypes.POINTER(_I)]
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
    out, args = _rbf_args("rbf_covariance", Xq, Xk, torch.float32, sig2)
    if out.numel() == 0:
        return out
    lib, fn, _ = _rbf_entry()
    _rbf_launch(lib, fn, _DTYPE_CODE[Xq.dtype], args, "rbf_covariance")
    rbf_launches += 1
    return out


def rbf_covariance_exact(Xq: torch.Tensor, Xk: torch.Tensor,
                         sig2) -> torch.Tensor:
    """``rbf_covariance`` computed in the inputs' dtype throughout (float32
    or float64), with the ICF kernel's arithmetic for its pivot column:
    fma norms and cross term, max, exp. The collective ICF loop's column
    (``picf.icf_factor_local``), so that a float64 loop picks the ICF
    kernel's pivots; ``rbf_covariance`` sums in float32 for every dtype.
    Shapes as ``rbf_covariance``."""
    global rbf_exact_launches
    if build.on_cpu(Xq, Xk):
        return ref.rbf_covariance_exact(Xq, Xk, sig2)
    if Xq.dtype not in _ICF_DTYPES:
        raise TypeError(f"rbf_covariance_exact takes float32 or float64; "
                        f"got {Xq.dtype}")
    out, args = _rbf_args("rbf_covariance_exact", Xq, Xk, Xq.dtype, sig2)
    if out.numel() == 0:
        return out
    lib, _, fn = _rbf_entry()
    _rbf_launch(lib, fn, _ICF_DTYPES[Xq.dtype], args,
                "rbf_covariance_exact")
    rbf_exact_launches += 1
    return out


def _rbf_args(name, Xq, Xk, sig2_dtype, sig2):
    """The checked arguments of an rbf.cu entry: the output and
    (Xq, Xk, sig2, out, B, n, m, d, q stride, k stride)."""
    refuse_grad(name, Xq, Xk, sig2)
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
    sq = n * d if Xq.ndim == 3 else 0
    sk = m * d if Xk.ndim == 3 else 0
    s2 = torch.as_tensor(sig2, dtype=sig2_dtype).to(Xq.device).reshape(1)
    return out, (Xq, Xk, s2, out, B, n, m, d, sq, sk)


def _rbf_launch(lib, fn, code: int, args, name: str) -> None:
    Xq, Xk, s2, out, B, n, m, d, sq, sk = args
    with torch.cuda.device(Xq.device):
        stream = torch.cuda.current_stream(Xq.device).cuda_stream
        err = fn(code, Xq.data_ptr(), Xk.data_ptr(), s2.data_ptr(),
                 out.data_ptr(), B, n, m, d, sq, sk, stream)
    build.check(lib, err, f"{name} launch")


_ICF_DTYPES = {torch.float32: 0, torch.float64: 1}


def _icf_dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _ICF_DTYPES:
        raise TypeError(f"the ICF kernel takes float32 or float64; got "
                        f"{dtype}")
    return _ICF_DTYPES[dtype]


def icf_plan(dtype: torch.dtype, n: int, R: int, d: int,
             cached_rows: int | None = None, device=None) -> dict:
    """The ICF kernel's launch for ``n`` candidates, ``R`` pivots and ``d``
    features on ``device`` (the current card): ``blocks`` (one an SM),
    ``width`` (columns a block), ``cached_rows`` (leading entries of each
    column's factor kept on chip: as many as fit, at most ``cached_rows``),
    ``smem_rows`` (of them in shared memory; the rest in registers),
    ``smem`` (bytes), ``row_stride`` (of the transposed factor) and
    ``max_rank`` (the largest R its shared memory takes)."""
    code = _icf_dtype_code(dtype)
    lib, _, plan, _ = _icf_entry()
    out = [_I(0) for _ in range(7)]
    with torch.cuda.device(device):
        code = plan(code, n, R, d,
                    -1 if cached_rows is None else cached_rows,
                    *(ctypes.byref(o) for o in out))
    keys = ("blocks", "width", "cached_rows", "smem_rows", "smem",
            "row_stride", "max_rank")
    info = dict(zip(keys, (o.value for o in out)))
    if R > info["max_rank"] > 0:
        raise ValueError(
            f"R={R} exceeds the ICF kernel's limit of {info['max_rank']} "
            f"pivots for {dtype} at d={d}: the pivot's factor column "
            f"F[:i, p] is staged in shared memory")
    build.check(lib, code, "rbf_icf plan")
    return info


def icf_factor(Xs: torch.Tensor, sig2, R: int, *,
               cached_rows: int | None = None, pivot_values: bool = False):
    """Pivoted incomplete Cholesky of the SE kernel matrix over pre-scaled
    candidates Xs (n, d): all R pivot steps in one cooperative launch of
    ``csrc/rbf_icf.cu``, with each step's kernel column computed in the
    update (rbf's arithmetic). Returns (F (R, n), pivots (R,) int64,
    residual (n,)) in Xs's dtype, float32 or float64, which is also the
    accumulation type; with ``pivot_values`` also (R,) d_p, each step's
    pivot value (the residual it pivoted on, before the step), which the
    kernel writes as it goes. ``cached_rows`` caps the factor entries each
    column keeps on chip (default: as many as fit; the result does not
    depend on it, which the checks on the card hold it to). Raises where
    the kernel cannot run; never falls back to the step loop."""
    global icf_launches
    if build.on_cpu(Xs):
        return ref.icf_factor(Xs, sig2, R, pivot_values=pivot_values)
    refuse_grad("icf_factor", Xs, sig2)
    if Xs.ndim != 2 or Xs.shape[0] < 1 or R < 0:
        raise ValueError(f"need Xs (n, d) with n >= 1 and R >= 0; got "
                         f"{tuple(Xs.shape)}, R={R}")
    Xs = Xs.contiguous()
    n, d = Xs.shape
    dt, dev = Xs.dtype, Xs.device
    plan = icf_plan(dt, n, R, d, cached_rows, dev)
    F = torch.empty((R, n), dtype=dt, device=dev)
    piv = torch.empty((R,), dtype=torch.long, device=dev)
    resid = torch.empty((n,), dtype=dt, device=dev)
    dpv = torch.empty((R,), dtype=dt, device=dev)
    Ft = torch.zeros((n, plan["row_stride"]), dtype=dt, device=dev)
    cand_v = torch.empty((2 * plan["blocks"],), dtype=dt, device=dev)
    cand_i = torch.empty((2 * plan["blocks"],), dtype=torch.int32,
                         device=dev)
    sync = torch.zeros((1,), dtype=torch.int32, device=dev)
    s2 = torch.as_tensor(sig2, dtype=dt).to(dev).reshape(1)
    lib, fn, _, _ = _icf_entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(_icf_dtype_code(dt), Xs.data_ptr(), s2.data_ptr(),
                  F.data_ptr(), Ft.data_ptr(), piv.data_ptr(),
                  resid.data_ptr(), dpv.data_ptr(), cand_v.data_ptr(),
                  cand_i.data_ptr(),
                  sync.data_ptr(), n, R, d,
                  -1 if cached_rows is None else cached_rows, stream)
    build.check(lib, code, "rbf_icf launch")
    icf_launches += 1
    return (F, piv, resid, dpv) if pivot_values else (F, piv, resid)


def icf_barrier_probe(dtype: torch.dtype, n: int, R: int, d: int,
                      device=None) -> None:
    """R empty grid barriers on the grid ``icf_factor`` launches for (n, d):
    the factorization's barrier floor (chip_smoke.py times it). Not counted
    as an ICF launch."""
    code = _icf_dtype_code(dtype)
    lib, _, _, probe = _icf_entry()
    dev = torch.device("cuda") if device is None else torch.device(device)
    sync = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = probe(code, n, R, d, sync.data_ptr(), stream)
    build.check(lib, code, "rbf_icf barrier probe")


def pick_serve_block_q(n: int) -> int:
    """Query-tile size for the fused serving kernel at batch size n: the
    largest power of two in 16..256 not exceeding n, else 8 (the reference's
    rule; the CUDA kernel then takes the largest of its query tiles that
    fits, see ``_kernel_tile``)."""
    for b in (256, 128, 64, 32, 16):
        if n >= b:
            return b
    return 8


def _embed_tri_inv(L: torch.Tensor, s_pad: int) -> torch.Tensor:
    """(s, s) Cholesky factor -> (s_pad, s_pad) lower-triangular INVERSE,
    embedded in an identity. Computed with a plain triangular solve outside
    the kernel, as the reference leaves it to XLA; ``tri_inv`` keeps it per
    factor. The CUDA kernel masks ragged panels itself, so ``xcov_diag``
    embeds with ``s_pad = s`` (no padding). Row-major, as the kernel reads
    it (the solve returns the transposed layout)."""
    s = L.shape[0]
    eye = torch.eye(s, dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    if s == s_pad:
        return Linv.contiguous()
    out = torch.eye(s_pad, dtype=L.dtype, device=L.device)
    out[:s, :s] = Linv
    return out


# id(factor) -> (weakref to the factor, its _version, its inverse)
_INVERSES: dict[int, tuple[weakref.ref, int, torch.Tensor]] = {}


def _forget(key: int, dead: weakref.ref) -> None:
    entry = _INVERSES.get(key)
    if entry is not None and entry[0] is dead:
        del _INVERSES[key]


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """L^{-1} of a lower Cholesky factor, built once per factor.

    A plan's factors live as long as its state, so the (s, s) inverse that
    the fused kernel multiplies by is built on the first dispatch and kept:
    keyed on the factor's identity through a weak reference (a freed factor
    drops its inverse) and on its ``_version`` (an in-place edit rebuilds).
    The reference inverts on every dispatch; the factors do not change
    between dispatches, so the result is the same bits. ``inverse_builds``
    counts the builds.
    """
    global inverse_builds
    key = id(L)
    entry = _INVERSES.get(key)
    if entry is not None and entry[0]() is L and entry[1] == L._version:
        return entry[2]
    inv = _embed_tri_inv(L, L.shape[0])
    inverse_builds += 1
    _INVERSES[key] = (weakref.ref(L, functools.partial(_forget, key)),
                      L._version, inv)
    return inv


def _kernel_tile(n: int, block_q: int | None, dtype: torch.dtype) -> int:
    """The kernel's query tile for ``dtype``: the largest of its tiles not
    above the serving tile (``block_q``, else the reference's rule)."""
    bq = block_q or pick_serve_block_q(n)
    tiles = _XCOV_TILES[dtype]
    return next((t for t in tiles if t <= bq), tiles[-1])


@functools.cache
def _tc_units(s: int, kc: int) -> int:
    """Blocks per query tile of the float32 kernel: panel p's k-range
    [0, min(64 (p + 1), s)) in chunks of kc (xcov_diag.cu's tc_units)."""
    return sum(-(-min((p + 1) * _XCOV_PANEL, s) // kc)
               for p in range(-(-s // _XCOV_PANEL)))


def _tc_chunk(n: int, s: int) -> int:
    """k-range of one block of the float32 kernel. Small batches cut each
    panel's k-range into chunks, so the card has blocks to fill it and no
    block runs the longest panel's whole chain: at s = 2048, 272 blocks of
    at most 4 steps of 32 for n <= 8, 144 of at most 8 for n <= 64, 4 x 80
    of at most 16 for n <= 256 (the fastest of 128, 256, 512 and whole
    panels at n = 8, 64 and 256 on the card, ``launch.xcov_sweep``). From
    257 queries the query tiles alone fill the card and the panels stay
    whole (no scratch, no second pass). The chunk doubles while the split
    partials would pass 64 MiB."""
    whole = -(-s // _XCOV_PANEL) * _XCOV_PANEL
    if n > 256:
        return whole
    kc = 128 if n <= 8 else 256 if n <= 64 else 512
    while kc < whole and \
            _tc_units(s, kc) * 2 * _XCOV_PANEL * n * 4 > 64 * 2 ** 20:
        kc *= 2
    return min(kc, whole)


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
    bfloat16, accumulating in float32). The factors' inverses come from
    ``tri_inv``: built on a factor's first dispatch, then kept.
    ``block_q`` is the serving tile; the kernel uses the largest of its
    query tiles not above it (``_kernel_tile``).
    """
    args = (Xq, Xk, L1, alpha) + ((L2,) if L2 is not None else ())
    if build.on_cpu(*args):
        return ref.xcov_diag(Xq, Xk, L1, alpha, sig2, L2)
    refuse_grad("xcov_diag", *args, sig2)
    s = Xk.shape[0]
    if L1.shape != (s, s) or (L2 is not None and L2.shape != (s, s)):
        raise ValueError(f"need (s, s) factors for s={s}; got "
                         f"{tuple(L1.shape)}"
                         + ("" if L2 is None else f", {tuple(L2.shape)}"))
    L2inv = tri_inv(L2) if L2 is not None else None
    return xcov_diag_inv(Xq, Xk, tri_inv(L1), alpha, sig2, L2inv,
                         block_q=block_q)


def xcov_diag_inv(Xq: torch.Tensor, Xk: torch.Tensor, L1inv: torch.Tensor,
                  alpha: torch.Tensor, sig2, L2inv: torch.Tensor | None = None,
                  *, block_q: int | None = None, kc: int | None = None):
    """The fused kernel alone, on the lower-triangular INVERSES of the
    cached factors (what ``xcov_diag`` passes it from ``tri_inv``); CUDA
    tensors only. Entries above the diagonal are never read. float32 runs
    on the tensor cores in 3xTF32 (``xcov_tc_launches``), float64 on the
    FP64 units. ``kc``, a multiple of 64, is the float32 kernel's k-range
    a block (default ``_tc_chunk``)."""
    global xcov_launches, xcov_tc_launches
    args = (Xq, Xk, L1inv, alpha) + ((L2inv,) if L2inv is not None else ())
    if build.on_cpu(*args):
        raise ValueError("xcov_diag_inv launches the CUDA kernel and takes "
                         "CUDA tensors; the plain path is xcov_diag")
    refuse_grad("xcov_diag_inv", *args, sig2)
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
    tile = _kernel_tile(n, block_q, dt)
    mean, var = torch.empty((2, n), dtype=dt, device=Xq.device)
    if n == 0:
        return mean, var
    tc = dt == torch.float32
    if not tc:
        kc = 0
    elif kc is None:
        kc = _tc_chunk(n, s) if s > 0 else 0
    elif kc < _XCOV_PANEL or kc % _XCOV_PANEL:
        raise ValueError(f"kc must be a positive multiple of {_XCOV_PANEL}; "
                         f"got {kc}")
    if s == 0 or d == 0 or -(-n // tile) > _GRID_Y_MAX \
            or (tc and _tc_units(s, kc) > _GRID_Y_MAX):
        raise ValueError(f"xcov_diag needs 0 < s, 0 < d and n <= "
                         f"{_GRID_Y_MAX * tile}; got s={s}, d={d}, n={n}")
    with_l2 = L2inv is not None
    Xk = Xk.to(dt).contiguous()
    alpha = alpha.to(dt).contiguous()
    L1inv = L1inv.to(dt).contiguous()
    L2inv = L2inv.to(dt).contiguous() if with_l2 else L1inv
    _check_cuda(Xq=Xq, Xk=Xk, L1inv=L1inv, L2inv=L2inv, alpha=alpha)
    # scratch: per-panel partial sums (3, panels, n), then the split
    # panels' partial V^T tiles (units, 2, 64, n)
    n_panels = -(-s // _XCOV_PANEL)
    split = tc and _tc_units(s, kc) > n_panels
    part = torch.empty(3 * n_panels * n + (
        _tc_units(s, kc) * 2 * _XCOV_PANEL * n if split else 0),
        dtype=dt, device=Xq.device)
    vpart = part[3 * n_panels * n:]
    s2 = torch.as_tensor(sig2, dtype=dt).to(Xq.device).reshape(1)
    lib, fn = _xcov_entry()
    tensor_cores = _I(0)
    with torch.cuda.device(Xq.device):
        stream = torch.cuda.current_stream(Xq.device).cuda_stream
        code = fn(_DTYPE_CODE[dt], tile, kc, int(with_l2),
                  Xq.data_ptr(), Xk.data_ptr(), L1inv.data_ptr(),
                  L2inv.data_ptr(), alpha.data_ptr(), s2.data_ptr(),
                  part.data_ptr(), vpart.data_ptr(), mean.data_ptr(),
                  var.data_ptr(), n, s, d, stream, ctypes.byref(tensor_cores))
    build.check(lib, code, "xcov_diag launch")
    xcov_launches += 1
    xcov_tc_launches += tensor_cores.value
    return mean, var
