"""Launch wrapper of the flash-attention CUDA kernels — port of
``repro.kernels.attention.ops``.

``attention`` takes the plain versions (``ref.py``) for CPU tensors, and
only because they lie on the CPU: there it routes long sliding-window
sequences to the chunked path, as the JAX package's jnp route does. For CUDA
tensors it launches ``csrc/flash_attention.cu`` or raises; it never falls
back. ``route`` picks the kernel from the inputs alone:

- ``"sm90"``: bfloat16 that TMA can address (D % 8 == 0, 16-byte aligned
  base pointers, strides that are multiples of 8 elements) goes to the
  Hopper kernel (wgmma + a TMA ring), read in place: GQA without the head
  broadcast, q/k/v/out with their own strides, ragged Tq, Tk and D masked
  by TMA's zero fill;
- ``"pad"``: any other bfloat16 input is first copied into zero-padded
  contiguous buffers (D up to the next multiple of 8, the softmax scale of
  the original D), takes the same kernel, and is sliced back;
- ``"f32"``: float32 goes to the CUDA-core FMA kernel, used by the
  consistency checks.

``flash_launches`` counts every kernel launch; ``flash_sm90_launches`` those
of the Hopper kernel, ``flash_noncausal_launches`` those without the causal
mask (an encoder's self-attention, cross-attention).

The backward is ``csrc/flash_attention_bwd.cu`` (FA2's two passes: a
query-tile-major kernel for dq, the log-sum-exp and D = rowsum(dO o O), a
key-tile-major one for dk and dv; bfloat16 on ``mma.sync``, float32 on the
CUDA cores). ``attention`` records it through ``_Flash`` only when grad
mode is on and an input requires grad; otherwise it launches the forward
alone, as serving does. ``flash_bwd_launches`` counts its C entry's calls
(each launches the two kernels). bfloat16 that the kernel cannot address
(D % 8 != 0, misaligned) is zero-padded to D up to a multiple of 8 first,
as the forward's ``"pad"`` route does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import ref

flash_launches = 0
flash_sm90_launches = 0
flash_noncausal_launches = 0
flash_bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_GRID_MAX = 65535      # the f32 kernel's B * Hq, the sm90 kernel's tiles
_MAX_D = 256
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_counts() -> None:
    global flash_launches, flash_sm90_launches, flash_noncausal_launches
    global flash_bwd_launches
    flash_launches = flash_sm90_launches = flash_noncausal_launches = 0
    flash_bwd_launches = 0


@functools.cache
def _entry():
    lib = build.library("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                   _I, _I, _P]
    fn.restype = _I
    lib.flash_last_encode_us.argtypes = []
    lib.flash_last_encode_us.restype = ctypes.c_double
    return lib, fn


@functools.cache
def _bwd_entry():
    lib = build.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = [_I] + [_P] * 10 + [_I] * 6 + [_P, _F, _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def last_encode_us() -> float:
    """Host microseconds the last bf16 launch spent encoding its three TMA
    tensor maps."""
    return _entry()[0].flash_last_encode_us()


def _plain(q, k, v, causal, window, scale, q_offset):
    Tq, Tk = q.shape[2], k.shape[2]
    if (causal and window is not None and Tq == Tk and q_offset == 0
            and Tq >= 2 * window and Tq % min(window, 512) == 0):
        return ref.attention_windowed_chunked(q, k, v, window=window,
                                              scale=scale)
    return ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA can tile ``t`` in place: D % 8 == 0 with unit stride, a 16-byte
    aligned base, and every stride of a non-trivial axis a multiple of 8
    elements (16 bytes)."""
    return (t.shape[-1] % 8 == 0 and t.stride(-1) == 1
            and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 and s > 0
                    for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call with these inputs takes: "sm90", "pad" or
    "f32" (see the module docstring). Decided by dtype, shape, strides and
    alignment alone."""
    if q.dtype == torch.float32:
        return "f32"
    return "sm90" if all(_tma_ok(t) for t in (q, k, v)) else "pad"


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` copied into a zero-filled contiguous (..., width) buffer."""
    out = t.new_zeros(t.shape[:-1] + (width,))
    out[..., :t.shape[-1]] = t
    return out


def _strides(t: torch.Tensor) -> list[int]:
    # an axis of length 1 is never stepped over; give it a stride TMA takes
    return [s if n > 1 else 8 for n, s in zip(t.shape[:3], t.stride()[:3])]


def _launch(q, k, v, out, causal, window, scale, q_offset) -> None:
    global flash_launches, flash_sm90_launches, flash_noncausal_launches
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    strides = torch.tensor([s for t in (q, k, v, out) for s in _strides(t)],
                           dtype=torch.int64)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Tq, Tk, D,
                  strides.data_ptr(), scale, int(q_offset), int(causal),
                  0 if window is None else int(window), stream)
    build.check(lib, code, "flash_attention launch")
    flash_launches += 1
    flash_sm90_launches += q.dtype == torch.bfloat16
    flash_noncausal_launches += not causal


def _check(q, k, v) -> None:
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernel takes bfloat16 or float32 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"need q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    if Hkv == 0 or Hq % Hkv or not 1 <= D <= _MAX_D:
        raise ValueError(f"need Hq % Hkv == 0 and 1 <= D <= {_MAX_D}; got "
                         f"Hq={Hq}, Hkv={Hkv}, D={D}")


def _forward(q, k, v, causal, window, scale, q_offset) -> torch.Tensor:
    _check(q, k, v)
    B, Hq, Tq, D = q.shape
    Tk = k.shape[2]
    kind = route(q, k, v)
    if (B * Hq if kind == "f32" else -(-Tq // 128)) > _GRID_MAX:
        raise ValueError(f"B * Hq = {B * Hq}, Tq = {Tq} exceed the kernel's "
                         f"grid")
    out = torch.empty_like(q)     # q's layout, so a transposed view stays one
    if out.numel() == 0:
        return out
    if Tk == 0:                   # no key: every row is 0
        return out.zero_()
    scale = (D ** -0.5) if scale is None else float(scale)
    if kind == "f32" and any(t.stride(-1) != 1 for t in (q, k, v)):
        q, k, v = (t.contiguous() for t in (q, k, v))
    if kind == "pad":
        width = -(-D // 8) * 8
        qp, kp, vp = (pad_head_dim(t, width) for t in (q, k, v))
        op = torch.empty_like(qp)
        _launch(qp, kp, vp, op, causal, window, scale, q_offset)
        out.copy_(op[..., :D])
        return out
    _launch(q, k, v, out, causal, window, scale, q_offset)
    return out


def _bwd_ok(t: torch.Tensor) -> bool:
    """The backward kernel reads and writes ``t`` in place: unit stride over
    D and, in bfloat16, what ``_tma_ok`` asks (16-byte rows)."""
    return t.stride(-1) == 1 and (t.dtype == torch.float32 or _tma_ok(t))


def _launch_bwd(q, k, v, o, do, causal, window, scale, q_offset):
    global flash_bwd_launches
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((2, B, Hq, Tq), dtype=torch.float32, device=q.device)
    strides = torch.tensor([s for t in (q, k, v, o, do, dq, dk, dv)
                            for s in _strides(t)], dtype=torch.int64)
    lib, fn = _bwd_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(_DTYPE_CODE[q.dtype], *(t.data_ptr() for t in (
                  q, k, v, o, do, dq, dk, dv, stats[0], stats[1])),
                  B, Hq, Hkv, Tq, Tk, D, strides.data_ptr(), scale,
                  int(q_offset), int(causal),
                  0 if window is None else int(window), stream)
    build.check(lib, code, "flash_attention_bwd launch")
    flash_bwd_launches += 1
    return dq, dk, dv


def attention_backward(q, k, v, out, dout, *, causal: bool = True,
                       window: int | None = None, scale: float | None = None,
                       q_offset: int = 0):
    """(dq, dk, dv) of ``attention`` at (q, k, v), given its output ``out``
    and the output's gradient ``dout``, in the inputs' dtypes and layouts.
    CPU tensors take the plain version (``ref.attention_backward``); CUDA
    tensors launch ``csrc/flash_attention_bwd.cu`` or raise."""
    if build.on_cpu(q, k, v, out, dout):
        grads = ref.attention_backward(q, k, v, dout, causal=causal,
                                       window=window, scale=scale,
                                       q_offset=q_offset)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must have q's shape {tuple(q.shape)};"
                         f" got {tuple(out.shape)}, {tuple(dout.shape)}")
    B, Hq, Tq, D = q.shape
    Tk = k.shape[2]
    if B * Hq > _GRID_MAX:
        raise ValueError(f"B * Hq = {B * Hq} exceeds the kernel's grid")
    if q.numel() == 0 or Tk == 0:
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    scale = (D ** -0.5) if scale is None else float(scale)
    dout = dout.to(q.dtype)
    args = [q, k, v, out, dout]
    if q.dtype == torch.bfloat16 and not all(_bwd_ok(t) for t in args):
        width = -(-D // 8) * 8
        grads = _launch_bwd(*(pad_head_dim(t, width) for t in args), causal,
                            window, scale, q_offset)
        return tuple(g[..., :D] for g in grads)
    args = [t if _bwd_ok(t) else t.contiguous() for t in args]
    return _launch_bwd(*args, causal, window, scale, q_offset)


class _Flash(torch.autograd.Function):
    """The forward kernel, with ``csrc/flash_attention_bwd.cu`` as its
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        out = _forward(q, k, v, causal, window, scale, q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, window, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, window, scale, q_offset = ctx.args
        dq, dk, dv = attention_backward(q, k, v, out, dout, causal=causal,
                                        window=window, scale=scale,
                                        q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Multi-head attention with GQA. q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk,
    D) with Hq % Hkv == 0. ``window``: keys within [i - window + 1, i].
    ``q_offset`` (a host int): absolute position of q[0], e.g. the cache
    length in a decode step. Output in q's dtype and memory layout; in grad
    mode, with an input that requires grad, differentiable through the
    backward kernel."""
    if build.on_cpu(q, k, v):
        return _plain(q, k, v, causal, window, scale, q_offset)
    if window is not None and window < 1:
        raise ValueError(f"window must be positive; got {window}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, window, scale, q_offset)
    return _forward(q, k, v, causal, window, scale, q_offset)
