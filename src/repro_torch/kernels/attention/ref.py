"""Plain PyTorch versions of flash attention (GQA, causal, sliding window)
— port of ``repro.kernels.attention.ref``.

``ops.attention`` takes these for CPU tensors; ``chip_smoke.py`` and the
card's tests hold the CUDA kernel against ``attention`` on the card, and
the backward kernel against ``attention_backward``.

One deliberate difference from the JAX oracle: a query row that sees no
valid key (possible only with a window or a q_offset past the keys) returns
0, as the flash kernels do (``acc / max(l, 1e-30)``), where the JAX oracle's
softmax over all -1e30 logits returns the mean of v. Every row with at least
one valid key is the same function.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(Tq: int, Tk: int, causal: bool, window: int | None, q_offset: int,
          device) -> torch.Tensor:
    qpos = torch.arange(Tq, device=device)[:, None] + q_offset
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Reference attention, softmax in float32 (float64 for float64
    inputs).

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D) with Hq % Hkv == 0 (GQA).
    ``window``: keys within [i - window + 1, i]. ``q_offset``: absolute
    position of q[0] (decode: Tq = 1, q_offset = cache length).
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct).reshape(B, Hkv, G, Tq, D)
    kf = k.to(ct)[:, :, None]
    vf = v.to(ct)[:, :, None]
    logits = (qf @ kf.transpose(-1, -2)) * scale              # (B,Hkv,G,Tq,Tk)
    mask = _mask(Tq, Tk, causal, window, q_offset, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1) * mask.any(-1, keepdim=True)
    out = probs @ vf
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, *, causal: bool = True,
                       window: int | None = None, scale: float | None = None,
                       q_offset: int = 0):
    """(dq, dk, dv) of ``attention`` at (q, k, v) for the output gradient
    ``dout``: autograd through ``attention`` in float32 (float64 for float64
    inputs). A row with no valid key contributes nothing."""
    ct = torch.promote_types(q.dtype, torch.float32)
    with torch.enable_grad():
        leaves = [t.detach().to(ct).requires_grad_(True) for t in (q, k, v)]
        out = attention(*leaves, causal=causal, window=window, scale=scale,
                        q_offset=q_offset)
        return torch.autograd.grad(out, leaves, dout.to(ct))


def attention_windowed_chunked(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, window: int,
                               scale: float | None = None, q_offset: int = 0,
                               chunk: int | None = None) -> torch.Tensor:
    """Sliding-window causal attention via fixed-span key slices: each query
    chunk only touches its (window + chunk)-wide key span, O(T (W + c) D)
    instead of the masked-full O(T^2 D).

    q: (B, Hq, T, D); k, v: (B, Hkv, T, D). Uses T % chunk == 0 (else one
    chunk); chunk defaults to min(window, 512).
    """
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    c = min(chunk or min(window, 512), T)
    if T % c:
        c = T
    span = window + c
    pad = (0, 0, window, 0)
    kf = torch.nn.functional.pad(k.to(torch.float32), pad)[:, :, None]
    vf = torch.nn.functional.pad(v.to(torch.float32), pad)[:, :, None]
    qf = q.to(torch.float32).reshape(B, Hkv, G, T, D)
    outs = []
    for i in range(T // c):
        qs = qf[:, :, :, i * c:(i + 1) * c]
        ks = kf[:, :, :, i * c:i * c + span]
        vs = vf[:, :, :, i * c:i * c + span]
        logits = (qs @ ks.transpose(-1, -2)) * scale
        qpos = i * c + torch.arange(c, device=q.device)[:, None] + q_offset
        kpos = (i * c - window + torch.arange(span, device=q.device)[None, :]
                + q_offset)
        mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos >= q_offset)
        logits = torch.where(mask, logits, NEG_INF)
        outs.append(torch.softmax(logits, dim=-1) @ vs)
    out = torch.cat(outs, dim=3)
    return out.reshape(B, Hq, T, D).to(q.dtype)
