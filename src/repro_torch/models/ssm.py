"""Mamba-2 (SSD, state space duality) mixer layer: chunked scan and decode —
port of ``repro.models.ssm``.

The sequence is split into chunks; the intra-chunk terms are decay-masked,
attention-like products (the SSD CUDA kernel on the card, see
``kernels.ssd``), and the inter-chunk terms flow through a short sequential
recurrence over per-chunk states (h, p, n). Single group (g = 1) B/C
projections; a scalar decay A per head.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import layers


class SSMState(NamedTuple):
    ssm: torch.Tensor    # (B, H, P, N) running state
    conv: torch.Tensor   # (B, K-1, conv_dim) last inputs of the causal conv


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    return d_inner, H, cfg.ssm_headdim, cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg, *, device,
             dtype=torch.float32) -> dict:
    d = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    conv_dim = d_inner + 2 * N                      # x, B, C go through conv
    return {
        # order: [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "in_proj": layers.init_normal((d, 2 * d_inner + 2 * N + H), gen,
                                      device, dtype, d ** -0.5),
        "conv_w": layers.init_normal((cfg.ssm_conv, conv_dim), gen, device,
                                     dtype, 0.2),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=device),
        "norm": torch.zeros((d_inner,), dtype=torch.float32, device=device),
        "out_proj": layers.init_normal((d_inner, d), gen, device, dtype,
                                       d_inner ** -0.5),
    }


def _split(cfg, zxbcdt: torch.Tensor):
    d_inner, H, P, N = dims(cfg)
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    Bm = zxbcdt[..., 2 * d_inner:2 * d_inner + N]
    Cm = zxbcdt[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, x, Bm, Cm, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, u: (B, T, D), w: (K, D): the sum of K shifted
    products in u's dtype, as the reference forms it, then SiLU in
    float32 (float64 for float64 u)."""
    K, T = w.shape[0], u.shape[1]
    upad = F.pad(u, (0, 0, K - 1, 0))
    out = upad[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + upad[:, i:i + T] * w[i]
    return F.silu(out.to(layers.wide(u.dtype))).to(u.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """exp-able segment sums: L[i, j] = sum_{j < k <= i} a_k (lower-tri)."""
    T = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    L = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, L, -torch.inf)


def ssd_scan(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD, the plain reference of the whole scan.
    xh: (B, L, H, P), dt: (B, L, H) post-softplus, A: (H,) negative decay
    rates, Bm/Cm: (B, L, N). Returns (B, L, H, P) and the final state
    (B, H, P, N)."""
    Bsz, L, H, P = xh.shape
    nc = L // chunk
    c = lambda t: t.reshape((Bsz, nc, chunk) + tuple(t.shape[2:]))
    xc, dtc, Bc, Cc = c(xh), c(dt), c(Bm), c(Cm)

    dA = (dtc * A).movedim(-1, 2)                     # (B,nc,H,cs) log-decays
    cum = torch.cumsum(dA, dim=-1)

    # 1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA))                     # (B,nc,H,cs,cs)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)       # (B,nc,cs,cs)
    M = G[:, :, None] * Lmat
    xdt = xc * dtc[..., None]                         # (B,nc,cs,H,P)
    Y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xdt)

    # 2) chunk states: decay-to-end weighted outer products
    decay_end = torch.exp(cum[..., -1:] - cum)        # (B,nc,H,cs)
    S = torch.einsum("bcjn,bchj,bcjhp->bchpn", Bc,
                     decay_end * dtc.movedim(-1, 2), xc)

    # 3) inter-chunk recurrence (sequential over nc chunks)
    chunk_decay = torch.exp(cum[..., -1])             # (B,nc,H)
    prev = torch.zeros_like(S[:, 0])
    prev_states = []
    for i in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, i, :, None, None] + S[:, i]
    prev_states = torch.stack(prev_states, dim=1)     # (B,nc,H,P,N)

    # 4) off-diagonal: the state entering the chunk, decayed to row i
    in_decay = torch.exp(cum)
    Y_off = torch.einsum("bcin,bchpn,bchi->bcihp", Cc, prev_states, in_decay)
    Y = (Y_diag + Y_off).reshape(Bsz, L, H, P)
    return Y, prev


def _gate_out(params, y, z, cfg, x, compute_dtype):
    y = layers.rms_norm(y * F.silu(z.to(layers.wide(compute_dtype)))
                        .to(compute_dtype),
                        params["norm"], cfg.norm_eps)
    return layers.matmul(y, params["out_proj"], compute_dtype).to(x.dtype)


def ssm_mixer(params: dict, x: torch.Tensor, cfg,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Full Mamba-2 block (training / prefill). x: (B, T, d)."""
    B, T, d = x.shape
    d_inner, H, P, N = dims(cfg)
    zxbcdt = layers.matmul(x, params["in_proj"], compute_dtype)
    z, xu, Bm, Cm, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xu, Bm, Cm], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"].to(compute_dtype))
    xu, Bm, Cm = (conv_out[..., :d_inner],
                  conv_out[..., d_inner:d_inner + N],
                  conv_out[..., d_inner + N:])
    f32 = layers.wide(compute_dtype)
    dt = F.softplus(dt.to(f32) + params["dt_bias"].to(f32))
    A = -torch.exp(params["A_log"].to(f32))                      # (H,)
    xh = xu.reshape(B, T, H, P).to(f32)
    Y, _ = ssd_ops.ssd_scan(xh, dt, A, Bm.to(f32), Cm.to(f32), cfg.ssm_chunk)
    Y = Y + params["D"].to(f32)[:, None] * xh
    y = Y.reshape(B, T, d_inner).to(compute_dtype)
    return _gate_out(params, y, z, cfg, x, compute_dtype)


def decode_heads(params: dict, x: torch.Tensor, cfg, state: SSMState,
                 compute_dtype=torch.bfloat16, heads: slice = slice(None)):
    """The decode step up to the gate: the input projection and causal
    conv of all channels, the state update and output of the SSM heads
    ``heads`` (the whole state's heads, or the slice a rank holds of them,
    ``state.ssm`` holding just those). Returns (y (B, len(heads), P) in the
    wide dtype, z (B, 1, d_inner), the new state)."""
    B = x.shape[0]
    d_inner, H, P, N = dims(cfg)
    f32 = layers.wide(compute_dtype)
    zxbcdt = layers.matmul(x, params["in_proj"], compute_dtype)
    z, xu, Bm, Cm, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xu, Bm, Cm], dim=-1)                    # (B,1,C)
    hist = torch.cat([state.conv, conv_in.to(state.conv.dtype)], dim=1)
    w = params["conv_w"].to(compute_dtype).to(f32)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist.to(f32), w))
    conv_out = conv_out[:, None].to(compute_dtype)
    xu, Bm, Cm = (conv_out[..., :d_inner],
                  conv_out[..., d_inner:d_inner + N],
                  conv_out[..., d_inner + N:])
    dt = F.softplus(dt.to(f32) + params["dt_bias"].to(f32))[:, 0]  # (B,H)
    A = -torch.exp(params["A_log"].to(f32))
    dt, A = dt[:, heads], A[heads]
    dA = torch.exp(dt * A)                                        # (B,h)
    xh = xu.reshape(B, H, P).to(f32)[:, heads]
    Bv = Bm[:, 0].to(f32)                                         # (B,N)
    Cv = Cm[:, 0].to(f32)
    new_ssm = (state.ssm * dA[..., None, None]
               + (dt[..., None] * xh)[..., None] * Bv[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", new_ssm, Cv) \
        + params["D"].to(f32)[heads, None] * xh
    return y, z, SSMState(new_ssm, hist[:, 1:])


def ssm_decode(params: dict, x: torch.Tensor, cfg, state: SSMState,
               compute_dtype=torch.bfloat16):
    """Single-token decode, x: (B, 1, d): an O(1) state update."""
    y, z, state = decode_heads(params, x, cfg, state, compute_dtype)
    y = y.reshape(x.shape[0], 1, -1).to(compute_dtype)
    return _gate_out(params, y, z, cfg, x, compute_dtype), state


def init_state(cfg, batch: int, *, device, dtype=torch.float32,
               conv_dtype=torch.bfloat16) -> SSMState:
    d_inner, H, P, N = dims(cfg)
    conv_dim = d_inner + 2 * N
    return SSMState(
        torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=conv_dtype,
                    device=device))
