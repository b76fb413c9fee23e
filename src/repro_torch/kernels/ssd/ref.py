"""Plain PyTorch version of the SSD intra-chunk kernel — port of
``repro.kernels.ssd.ref``, batched over (batch * chunk, head).

``ops.intra_chunk`` takes it for CPU tensors; ``chip_smoke.py`` and the
card's tests hold the CUDA kernel against it on the card, and the backward
kernel against ``intra_chunk_backward``.
"""
from __future__ import annotations

import torch


def intra_chunk(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor,
                Cc: torch.Tensor):
    """Every (batch * chunk, head) tile of the SSD algorithm, in float32.

    xdt: (BC, cs, H, P) dt-weighted inputs; dA: (BC, H, cs) log-decay
    increments; Bc/Cc: (BC, cs, N) input/output projections (shared across
    heads).

    Returns Y_diag (BC, cs, H, P), the intra-chunk output; S (BC, H, P, N),
    the chunk state decayed to the chunk's end; cum (BC, H, cs), the
    cumulative log-decay.
    """
    xdt, dA, Bc, Cc = (t.to(torch.float32) for t in (xdt, dA, Bc, Cc))
    cs = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)                         # (BC, H, cs)
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=dA.device))
    seg = cum[..., :, None] - cum[..., None, :]            # (BC, H, cs, cs)
    L = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    G = Cc @ Bc.transpose(1, 2)                            # (BC, cs, cs)
    M = G[:, None] * L                                     # (BC, H, cs, cs)
    Y = torch.einsum("bhij,bjhp->bihp", M, xdt)
    decay_end = torch.exp(cum[..., -1:] - cum)             # (BC, H, cs)
    S = torch.einsum("bjhp,bjn,bhj->bhpn", xdt, Bc, decay_end)
    return Y, S, cum


def intra_chunk_backward(xdt, dA, Bc, Cc, dY, dS, dcum):
    """(dxdt, ddA, dB, dC) of ``intra_chunk`` at (xdt, dA, Bc, Cc) for the
    output gradients (dY, dS, dcum; None reads as zero): autograd through
    ``intra_chunk`` in float32."""
    with torch.enable_grad():
        leaves = [t.detach().to(torch.float32).requires_grad_(True)
                  for t in (xdt, dA, Bc, Cc)]
        outs = intra_chunk(*leaves)
        grads = [torch.zeros_like(o) if g is None else g.to(torch.float32)
                 for o, g in zip(outs, (dY, dS, dcum))]
        return torch.autograd.grad(outs, leaves, grads)
