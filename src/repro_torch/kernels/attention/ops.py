"""Launch wrapper of the flash-attention CUDA kernel — port of
``repro.kernels.attention.ops``.

``attention`` takes the plain versions (``ref.py``) for CPU tensors, and
only because they lie on the CPU: there it routes long sliding-window
sequences to the chunked path, as the JAX package's jnp route does. For CUDA
tensors it launches ``csrc/flash_attention.cu`` or raises; it never falls
back. Unlike the Pallas route, nothing is copied or padded first: the kernel
reads the KV head of each query head in place (GQA), takes q/k/v/out with
their own strides (unit stride over the head dimension), and masks ragged
Tq, Tk and D itself. ``flash_launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import ref

flash_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_GRID_Y_MAX = 65535
_MAX_D = 256
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_counts() -> None:
    global flash_launches
    flash_launches = 0


@functools.cache
def _entry():
    lib = build.library("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                   _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def _plain(q, k, v, causal, window, scale, q_offset):
    Tq, Tk = q.shape[2], k.shape[2]
    if (causal and window is not None and Tq == Tk and q_offset == 0
            and Tq >= 2 * window and Tq % min(window, 512) == 0):
        return ref.attention_windowed_chunked(q, k, v, window=window,
                                              scale=scale)
    return ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)


def _vec_ok(*tensors) -> bool:
    """8 bf16 values (16 bytes) per load: D % 8 == 0, 16-byte aligned base,
    and every row stride a multiple of 8 elements."""
    return all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in t.stride()[:3])
               for t in tensors)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Multi-head attention with GQA. q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk,
    D) with Hq % Hkv == 0. ``window``: keys within [i - window + 1, i].
    ``q_offset`` (a host int): absolute position of q[0], e.g. the cache
    length in a decode step. Output in q's dtype and memory layout."""
    global flash_launches
    if build.on_cpu(q, k, v):
        return _plain(q, k, v, causal, window, scale, q_offset)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernel takes bfloat16 or float32 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"need q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv or not 1 <= D <= _MAX_D:
        raise ValueError(f"need Hq % Hkv == 0 and 1 <= D <= {_MAX_D}; got "
                         f"Hq={Hq}, Hkv={Hkv}, D={D}")
    if B * Hq > _GRID_Y_MAX:
        raise ValueError(f"B * Hq = {B * Hq} exceeds the kernel's grid")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive; got {window}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)     # q's layout, so a transposed view stays one
    if out.numel() == 0:
        return out
    scale = (D ** -0.5) if scale is None else float(scale)
    strides = torch.tensor([s for t in (q, k, v, out) for s in t.stride()[:3]],
                           dtype=torch.int64)
    vec = q.dtype == torch.bfloat16 and _vec_ok(q, k, v)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Tq, Tk, D,
                  strides.data_ptr(), scale, int(q_offset), int(causal),
                  0 if window is None else int(window), int(vec), stream)
    build.check(lib, code, "flash_attention launch")
    flash_launches += 1
    return out
