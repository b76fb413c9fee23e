"""The full SSD scan around the intra-chunk CUDA kernel — port of
``repro.kernels.ssd.ops``.

``intra_chunk`` takes the plain version (``ref.py``) for CPU tensors, and
only because they lie on the CPU; for CUDA tensors it launches
``csrc/ssd_intra_chunk.cu`` or raises, never falling back. ``ssd_scan`` runs
the same steps on either device: the intra-chunk block through
``intra_chunk``, then the O(n_chunks) inter-chunk state recurrence and the
off-diagonal combine in PyTorch, as the JAX package leaves them to XLA.
``ssd_launches`` counts kernel launches.

The backward is ``csrc/ssd_intra_chunk_bwd.cu`` (float32 on the CUDA cores:
G = C B^T recomputed, the heads' dG and dB partials, dxdt, ddA, then dB and
dC summed over head groups in a fixed order, no atomics). ``intra_chunk``
records it through ``_SSD`` only when grad mode is on and an input
requires grad; otherwise it launches the forward alone.
``ssd_bwd_launches`` counts its C entry's calls (three kernels each).
bfloat16 inputs are differentiated in float32 (the forward casts them so)
and their gradients returned in bfloat16.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

ssd_launches = 0
ssd_bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_MAX_CS = 1024
_GRID_Y_MAX = 65535
_P, _I = ctypes.c_void_p, ctypes.c_int


# the backward's head groups: enough (chunk, group) blocks to fill the
# card's 132 SMs twice
_BWD_BLOCKS = 264


def bwd_head_groups(BC: int, H: int) -> tuple[int, int]:
    """(heads a group, groups) of the backward's (chunk, head group)
    blocks for BC chunks of H heads: the fewest heads a group that still
    gives _BWD_BLOCKS blocks (the last group may hold fewer)."""
    hpg = -(-H // max(1, min(H, -(-_BWD_BLOCKS // BC))))
    return hpg, -(-H // hpg)


def reset_counts() -> None:
    global ssd_launches, ssd_bwd_launches
    ssd_launches = ssd_bwd_launches = 0


@functools.cache
def _entry():
    lib = build.library("ssd_intra_chunk")
    fn = lib.ssd_intra_chunk
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def intra_chunk(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor,
                Cc: torch.Tensor):
    """xdt: (BC, cs, H, P); dA: (BC, H, cs); Bc/Cc: (BC, cs, N), float32 or
    bfloat16 (one dtype on the card). Returns Y_diag (BC, cs, H, P),
    S (BC, H, P, N) and cum (BC, H, cs), all float32; in grad mode, with an
    input that requires grad, differentiable through the backward
    kernel."""
    args = (xdt, dA, Bc, Cc)
    if build.on_cpu(*args):
        return ref.intra_chunk(xdt, dA, Bc, Cc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SSD.apply(*args)
    return _forward(*args)


@functools.cache
def _bwd_entry():
    lib = build.library("ssd_intra_chunk_bwd")
    fn = lib.ssd_intra_chunk_bwd
    fn.argtypes = [_P] * 14 + [_I] * 6 + [_P]
    fn.restype = _I
    return lib, fn


def _shapes(xdt, dA, Bc, Cc) -> tuple[int, ...]:
    """(BC, cs, H, P, N) of inputs both kernels take; raises otherwise."""
    if xdt.ndim != 4:
        raise ValueError(f"xdt must be (BC, cs, H, P); got {tuple(xdt.shape)}")
    BC, cs, H, P = xdt.shape
    N = Bc.shape[-1]
    if dA.shape != (BC, H, cs) or Bc.shape != (BC, cs, N) \
            or Cc.shape != (BC, cs, N):
        raise ValueError(f"need dA (BC, H, cs) and Bc/Cc (BC, cs, N) for "
                         f"xdt {tuple(xdt.shape)}; got {tuple(dA.shape)}, "
                         f"{tuple(Bc.shape)}, {tuple(Cc.shape)}")
    if not 1 <= cs <= _MAX_CS or BC > _GRID_Y_MAX:
        raise ValueError(f"the kernel takes 1 <= cs <= {_MAX_CS} and "
                         f"BC <= {_GRID_Y_MAX}; got cs={cs}, BC={BC}")
    return BC, cs, H, P, N


def _forward(xdt, dA, Bc, Cc):
    global ssd_launches
    args = (xdt, dA, Bc, Cc)
    if xdt.dtype not in _DTYPE_CODE or any(t.dtype != xdt.dtype
                                           for t in args):
        raise TypeError(f"the SSD kernel takes float32 or bfloat16 inputs of "
                        f"one dtype; got {[t.dtype for t in args]}")
    BC, cs, H, P, N = _shapes(*args)
    xdt, dA, Bc, Cc = (t.contiguous() for t in args)
    dev = xdt.device
    Y = torch.empty((BC, cs, H, P), dtype=torch.float32, device=dev)
    S = torch.empty((BC, H, P, N), dtype=torch.float32, device=dev)
    cum = torch.empty((BC, H, cs), dtype=torch.float32, device=dev)
    if BC == 0 or H == 0:
        return Y, S.zero_(), cum
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(_DTYPE_CODE[xdt.dtype], xdt.data_ptr(), dA.data_ptr(),
                  Bc.data_ptr(), Cc.data_ptr(), Y.data_ptr(), S.data_ptr(),
                  cum.data_ptr(), BC, cs, H, P, N, stream)
    build.check(lib, code, "ssd_intra_chunk launch")
    ssd_launches += 1
    return Y, S, cum


def intra_chunk_backward(xdt, dA, Bc, Cc, dY, dS, dcum):
    """(dxdt, ddA, dB, dC) of ``intra_chunk`` at (xdt, dA, Bc, Cc) for the
    output gradients (None reads as zero), in the inputs' dtypes. CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/ssd_intra_chunk_bwd.cu`` or raise."""
    global ssd_bwd_launches
    args = (xdt, dA, Bc, Cc)
    if build.on_cpu(*args):
        grads = ref.intra_chunk_backward(*args, dY, dS, dcum)
        return tuple(g.to(t.dtype) for g, t in zip(grads, args))
    BC, cs, H, P, N = _shapes(*args)
    if any(t.dtype not in _DTYPE_CODE for t in args):
        raise TypeError(f"the SSD backward takes float32 or bfloat16 inputs;"
                        f" got {[t.dtype for t in args]}")
    dev = xdt.device
    f32 = dict(dtype=torch.float32, device=dev)
    outs = ((BC, cs, H, P), (BC, H, P, N), (BC, H, cs))
    dY, dS, dcum = (torch.zeros(s, **f32) if g is None
                    else g.to(torch.float32).contiguous()
                    for g, s in zip((dY, dS, dcum), outs))
    ins = [t.to(torch.float32).contiguous() for t in args]
    grads = [torch.empty_like(t) for t in ins]
    if BC == 0 or H == 0 or P == 0 or N == 0:
        return tuple(g.zero_().to(t.dtype) for g, t in zip(grads, args))
    hpg, ng = bwd_head_groups(BC, H)
    G = torch.empty((BC, cs, cs), **f32)
    dGp = torch.zeros((BC, ng, cs, cs), **f32)
    dBp = torch.zeros((BC, ng, cs, N), **f32)
    lib, fn = _bwd_entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*(t.data_ptr() for t in (*ins, dY, dS, dcum, *grads, G,
                                           dGp, dBp)),
                  BC, cs, H, P, N, hpg, stream)
    build.check(lib, code, "ssd_intra_chunk_bwd launch")
    ssd_bwd_launches += 1
    return tuple(g.to(t.dtype) for g, t in zip(grads, args))


class _SSD(torch.autograd.Function):
    """The intra-chunk kernel, with ``csrc/ssd_intra_chunk_bwd.cu`` as its
    backward."""

    @staticmethod
    def forward(ctx, xdt, dA, Bc, Cc):
        ctx.save_for_backward(xdt, dA, Bc, Cc)
        return _forward(xdt, dA, Bc, Cc)

    @staticmethod
    def backward(ctx, dY, dS, dcum):
        return intra_chunk_backward(*ctx.saved_tensors, dY, dS, dcum)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """xh: (B, L, H, P); dt: (B, L, H) post-softplus; A: (H,) negative
    rates; Bm/Cm: (B, L, N), with L % chunk == 0. Returns (Y (B, L, H, P),
    final state (B, H, P, N)), float32."""
    B, L, H, P = xh.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc = L // chunk
    BC = B * nc
    xdt = (xh * dt[..., None]).reshape(BC, chunk, H, P)
    dA = (dt * A[None, None, :]).reshape(B, nc, chunk, H)
    dA = dA.permute(0, 1, 3, 2).reshape(BC, H, chunk)
    Bc = Bm.reshape(BC, chunk, N)
    Cc = Cm.reshape(BC, chunk, N)
    Y_diag, S, cum = intra_chunk(xdt, dA, Bc, Cc)

    # inter-chunk recurrence, sequential over the nc chunks
    S_b = S.reshape(B, nc, H, P, N)
    cum_b = cum.reshape(B, nc, H, chunk)
    chunk_decay = torch.exp(cum_b[..., -1])                   # (B, nc, H)
    prev = torch.zeros_like(S_b[:, 0])
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + S_b[:, c]
    prev_states = torch.stack(prev_states, dim=1)             # (B,nc,H,P,N)

    # off-diagonal: the state entering each chunk, decayed to row i
    in_decay = torch.exp(cum_b)                               # (B,nc,H,cs)
    Cc_b = Cm.reshape(B, nc, chunk, N).to(torch.float32)
    Y_off = torch.einsum("bcin,bchpn,bchi->bcihp", Cc_b, prev_states,
                         in_decay)
    Y = (Y_diag.reshape(B, nc, chunk, H, P) + Y_off).reshape(B, L, H, P)
    return Y, prev
