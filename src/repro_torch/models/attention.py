"""Attention layer: GQA projections, RoPE/M-RoPE, qk-norm, sliding window,
the KV cache for decode and cross-attention for enc-dec models — port of
``repro.models.attention``.

The full-sequence path, the decode step and cross-attention all score
through ``kernels.attention.ops.attention``: the flash CUDA kernel for CUDA
tensors, the plain version for CPU tensors. The JAX package sends its
decode and cross-attention calls to the jnp path; here they are the same
kernel, with Tq = 1 and q_offset = the cache length for decode, and
``causal=False`` against the encoder's keys for cross-attention (and for
the encoder's own self-attention). The ring-buffer decode branch stays
inline PyTorch, as in JAX.

The KV cache is updated in place: ``attend_decode`` writes the new key and
value into the cache's buffers and returns a ``KVCache`` over the same
buffers with ``length + 1``. ``length`` is a host int, so a decode step
never waits for the device to report it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import layers


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, Hkv, T_max, Dh)
    v: torch.Tensor    # (B, Hkv, T_max, Dh)
    length: int        # filled prefix


def init_attn(gen: torch.Generator, cfg, *, cross: bool = False, device,
              dtype=torch.float32) -> dict:
    """The projections of one attention layer. A cross-attention layer
    (``cross``) has the same leaves: its wk and wv project the encoder's
    states."""
    d, hd = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    p = {
        "wq": layers.init_normal((d, Hq * hd), gen, device, dtype, s),
        "wk": layers.init_normal((d, Hkv * hd), gen, device, dtype, s),
        "wv": layers.init_normal((d, Hkv * hd), gen, device, dtype, s),
        "wo": layers.init_normal((Hq * hd, d), gen, device, dtype,
                                 (Hq * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
    return p


def _heads(y: torch.Tensor, B: int, T: int, H: int, hd: int) -> torch.Tensor:
    """(B, T, H * hd) -> a (B, H, T, hd) view (no copy)."""
    return y.reshape(B, T, H, hd).transpose(1, 2)


def _project(params: dict, x: torch.Tensor, cfg, compute_dtype):
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = _heads(layers.matmul(x, params["wq"], compute_dtype), B, T,
               cfg.n_heads, hd)
    k = _heads(layers.matmul(x, params["wk"], compute_dtype), B, T,
               cfg.n_kv_heads, hd)
    v = _heads(layers.matmul(x, params["wv"], compute_dtype), B, T,
               cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope(q, k, positions, cfg):
    if cfg.mrope:
        pos3 = positions if positions.ndim == 3 else \
            positions[:, None, :].expand(positions.shape[0], 3,
                                         positions.shape[1])
        q = layers.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _merge(o: torch.Tensor, params: dict, x: torch.Tensor, compute_dtype):
    """(B, Hq, T, hd) -> output projection, in x's dtype."""
    B, _, T, _ = o.shape
    o = o.transpose(1, 2).reshape(B, T, -1)
    return layers.matmul(o, params["wo"], compute_dtype).to(x.dtype)


def attend(params: dict, x: torch.Tensor, cfg, *, window=None,
           positions=None, causal: bool = True, use_rope: bool = True,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Full-sequence attention (training / prefill without cache)."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    q, k, v = _project(params, x, cfg, compute_dtype)
    if use_rope:
        q, k = _rope(q, k, positions, cfg)
    o = attn_ops.attention(q, k, v, causal=causal, window=window)
    return _merge(o, params, x, compute_dtype)


def attend_decode(params: dict, x: torch.Tensor, cfg, cache: KVCache, *,
                  window=None, compute_dtype=torch.bfloat16):
    """Single-token decode against a KV cache, updated in place.
    x: (B, 1, d).

    Ring-buffer mode: when the cache holds exactly ``window`` slots, writes
    wrap modulo the window and scoring uses the ring's logical positions.
    """
    o, cache = decode_heads(params, x, cfg, cache, window=window,
                            compute_dtype=compute_dtype)
    return _merge(o, params, x, compute_dtype), cache


def decode_heads(params: dict, x: torch.Tensor, cfg, cache: KVCache, *,
                 window=None, compute_dtype=torch.bfloat16):
    """``attend_decode`` before the output projection: the heads' outputs
    (B, Hq, 1, hd) and the cache. ``params`` and ``cfg`` may hold a slice
    of the heads (wq, wk, wv's columns of ``cfg.n_heads`` query heads and
    their ``cfg.n_kv_heads`` KV heads), as a rank of a mesh does."""
    B = x.shape[0]
    n = cache.length
    pos = torch.full((B, 1), n, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project(params, x, cfg, compute_dtype)
    q, k_new = _rope(q, k_new, pos, cfg)

    W = cache.k.shape[2]
    ring = window is not None and W == window
    slot = n % W if ring else n
    if slot >= W:
        raise ValueError(f"KV cache of {W} slots is full (length {n})")
    cache.k[:, :, slot] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[:, :, slot] = v_new[:, :, 0].to(cache.v.dtype)
    k, v = cache.k, cache.v

    if ring:
        # logical position held by ring slot s: n - ((slot - s) mod W)
        s = torch.arange(W, device=x.device)
        valid = (n - torch.remainder(slot - s, W)) >= 0
        G = cfg.n_heads // cfg.n_kv_heads
        f32 = layers.wide(compute_dtype)
        qf = q.to(f32).reshape(B, cfg.n_kv_heads, G, 1, -1)
        kf = k.to(f32)[:, :, None]
        vf = v.to(f32)[:, :, None]
        scores = (qf @ kf.transpose(-1, -2)) * cfg.head_dim ** -0.5
        scores = torch.where(valid, scores, -1e30)
        o = torch.softmax(scores, dim=-1) @ vf
        o = o.reshape(B, cfg.n_heads, 1, -1).to(compute_dtype)
    else:
        # full cache: the causal mask with q_offset hides the unfilled tail
        o = attn_ops.attention(q, k, v, causal=True, window=window,
                               q_offset=n)
    return o, KVCache(cache.k, cache.v, n + 1)


def project_cross_kv(params: dict, enc_kv: torch.Tensor, cfg,
                     compute_dtype=torch.bfloat16):
    """Encoder-side K and V of one cross-attention layer, (B, Hkv, Te, hd)
    each: computed once per request, not at every decode step."""
    B, Te, _ = enc_kv.shape
    hd = cfg.head_dim
    k = _heads(layers.matmul(enc_kv, params["wk"], compute_dtype), B, Te,
               cfg.n_kv_heads, hd)
    v = _heads(layers.matmul(enc_kv, params["wv"], compute_dtype), B, Te,
               cfg.n_kv_heads, hd)
    return k, v


def attend_cross(params: dict, x: torch.Tensor, enc_kv, cfg,
                 compute_dtype=torch.bfloat16, kv=None) -> torch.Tensor:
    """Cross-attention of x (B, T, d) over the encoder's output ``enc_kv``,
    or over its precomputed (k, v) given as ``kv``: no RoPE, no mask. The
    queries take qk-norm as the reference's do; the encoder's keys do
    not."""
    k, v = kv if kv is not None else project_cross_kv(params, enc_kv, cfg,
                                                      compute_dtype)
    o = attn_ops.attention(cross_query(params, x, cfg, compute_dtype), k, v,
                           causal=False)
    return _merge(o, params, x, compute_dtype)


def cross_query(params: dict, x: torch.Tensor, cfg,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """A cross-attention layer's queries (B, cfg.n_heads, T, hd), with
    qk-norm; no RoPE."""
    B, T, _ = x.shape
    q = _heads(layers.matmul(x, params["wq"], compute_dtype), B, T,
               cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
    return q


def init_cache(cfg, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16) -> KVCache:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)
