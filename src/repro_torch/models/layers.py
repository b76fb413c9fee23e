"""Shared transformer building blocks — port of ``repro.models.layers``.

Parameters are plain dicts of tensors with the JAX package's leaf names.
Every matrix product casts both operands to the compute dtype (bfloat16 by
default, as in the reference); norms, RoPE, the SiLU and the logits are
computed in float32, or in float64 when that is the compute dtype
(``wide``). ``wide`` exists for the float64 test of the steps over a mesh
(``tests/test_torch_mesh.py``), which holds them to the one-process step
within 1e-10: float32 passes in a float64 run would not allow that. Under
bfloat16 and float32 compute it is float32, as before.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the model's float32 passes under compute dtype
    ``dtype``: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm that scales by ``1 + weight`` (zero-initialised weights),
    not by ``weight`` as ``torch.nn.RMSNorm`` does."""
    x32 = x.to(wide(x.dtype))
    out = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * (1.0 + weight.to(x32.dtype))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric when weight/bias are None (OLMo)."""
    x32 = x.to(wide(x.dtype))
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.to(x32.dtype)
    if bias is not None:
        out = out + bias.to(x32.dtype)
    return out.to(x.dtype)


def make_norm(cfg):
    """Returns (init_fn(device) -> params|None, apply_fn(x, params))."""
    if cfg.nonparametric_ln:
        return (lambda device: None,
                lambda x, p: layer_norm(x, None, None, cfg.norm_eps))
    return (lambda device: torch.zeros((cfg.d_model,), dtype=torch.float32,
                                       device=device),
            lambda x, p: rms_norm(x, p, cfg.norm_eps))


def matmul(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` with both operands cast to the compute dtype."""
    return x.to(dtype) @ w.to(dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None,
               dtype=torch.float32) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=dtype,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (x1, x2) of the last axis, not interleaved
    pairs."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(angles.dtype), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device, wide(x.dtype))  # (D/2,)
    angles = positions[:, None, :, None].to(freqs.dtype) * freqs
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the D/2 frequency slots are split into
    (temporal, height, width) sections, each rotated by its own position
    id. positions3: (B, 3, T)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device, wide(x.dtype))
    sec = torch.cumsum(torch.tensor((0,) + tuple(sections)), 0)
    slot = torch.arange(D // 2)
    which = torch.clamp(torch.searchsorted(sec, slot, right=True) - 1, 0, 2)
    pos = positions3.to(freqs.dtype)[:, which.to(x.device), :]  # (B,D/2,T)
    angles = pos.transpose(1, 2)[:, None, :, :] * freqs
    return _rotate(x, angles)


def init_normal(shape, gen, device, dtype, std) -> torch.Tensor:
    """Normal(0, std^2) draws from ``gen`` (on its device), in ``dtype``:
    the reference's initialiser scales, not its bits."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, device,
             dtype=torch.float32) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "w_gate": init_normal((d_model, d_ff), gen, device, dtype, s_in),
        "w_in": init_normal((d_model, d_ff), gen, device, dtype, s_in),
        "w_out": init_normal((d_ff, d_model), gen, device, dtype, s_out),
    }


def mlp(params: dict, x: torch.Tensor,
        compute_dtype=torch.bfloat16) -> torch.Tensor:
    g = matmul(x, params["w_gate"], compute_dtype)
    h = matmul(x, params["w_in"], compute_dtype)
    y = F.silu(g.to(wide(compute_dtype))).to(compute_dtype) * h
    return matmul(y, params["w_out"], compute_dtype).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int, tie: bool, *,
               device, dtype=torch.float32) -> dict:
    p = {"tok": init_normal((vocab, d_model), gen, device, dtype, 0.02)}
    if not tie:
        p["unembed"] = init_normal((d_model, vocab), gen, device, dtype,
                                   d_model ** -0.5)
    return p


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: dict, x: torch.Tensor, compute_dtype=torch.bfloat16,
            n_valid: int | None = None) -> torch.Tensor:
    """float32 logits (float64 under a float64 compute dtype); columns at
    or beyond ``n_valid`` (vocab-table padding, see ``configs.base``) are
    -1e30."""
    w = params.get("unembed")
    if w is None:
        w = params["tok"].T
    logits = matmul(x, w, compute_dtype).to(wide(compute_dtype))
    if n_valid is not None and n_valid < logits.shape[-1]:
        logits[..., n_valid:] = -1e30
    return logits
