"""Generic LM stack for the dense and SSM families — port of
``repro.models.transformer``, driven by ``ModelConfig.layer_pattern``.

The JAX package stacks the layer parameters per pattern position and scans
over periods. The port keeps a flat list instead: ``params["layers"][i]`` is
layer i of ``cfg.plan()``, so stacked leaf ``[pos][i]`` of the reference is
layer ``i * period + pos``, and the remainder layers follow. Configurations
with MoE layers or an encoder raise ``NotImplementedError``: those paths
are still to be ported (ROADMAP queue 1, "MoE/enc-dec/VLM").
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.configs.base import LayerDesc, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference not ported yet."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP queue 1, MoE/enc-dec/VLM)")
    if any(d.moe for d in cfg.layer_pattern):
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue 1, "
            f"MoE/enc-dec/VLM)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, desc: LayerDesc, *,
               device, dtype=torch.float32) -> dict:
    norm_init, _ = layers.make_norm(cfg)
    p = {"ln1": norm_init(device), "ln2": norm_init(device)}
    if desc.kind == "attn":
        p["attn"] = attn.init_attn(gen, cfg, device=device, dtype=dtype)
    else:
        p["ssm"] = ssm.init_ssm(gen, cfg, device=device, dtype=dtype)
    if cfg.d_ff > 0:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                   device=device, dtype=dtype)
    else:
        del p["ln2"]   # pure-mixer block (Mamba-2): no FFN sub-block
    return p


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None, dtype=torch.float32) -> dict:
    """Random parameters with the reference's scales (in distribution, not
    bit for bit), on the CUDA card unless ``device`` names another.
    ``generator`` must live on that device."""
    check_supported(cfg)
    dev = _device.resolve(device)
    params = {
        "embed": layers.init_embed(generator, cfg.vocab_padded, cfg.d_model,
                                   cfg.tie_embeddings, device=dev,
                                   dtype=dtype),
        "layers": [init_layer(generator, cfg, desc, device=dev, dtype=dtype)
                   for desc in cfg.plan()],
    }
    norm_init, _ = layers.make_norm(cfg)
    params["final_norm"] = norm_init(dev)
    return params


# ---------------------------------------------------------------------------
# layer application (shared by prefill and decode)
# ---------------------------------------------------------------------------

def apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                *, positions=None, causal: bool = True,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    _, norm = layers.make_norm(cfg)
    h = norm(x, p["ln1"])
    if desc.kind == "attn":
        h = attn.attend(p["attn"], h, cfg, window=desc.window,
                        positions=positions, causal=causal,
                        compute_dtype=compute_dtype)
    else:
        h = ssm.ssm_mixer(p["ssm"], h, cfg, compute_dtype=compute_dtype)
    x = x + h
    if "ln2" not in p:                       # pure-mixer block (no FFN)
        return x
    return x + layers.mlp(p["mlp"], norm(x, p["ln2"]),
                          compute_dtype=compute_dtype)


def apply_layer_decode(p: dict, x: torch.Tensor, cache, cfg: ModelConfig,
                       desc: LayerDesc, *, compute_dtype=torch.bfloat16):
    _, norm = layers.make_norm(cfg)
    h = norm(x, p["ln1"])
    if desc.kind == "attn":
        h, cache = attn.attend_decode(p["attn"], h, cfg, cache,
                                      window=desc.window,
                                      compute_dtype=compute_dtype)
    else:
        h, cache = ssm.ssm_decode(p["ssm"], h, cfg, cache,
                                  compute_dtype=compute_dtype)
    x = x + h
    if "ln2" not in p:
        return x, cache
    return x + layers.mlp(p["mlp"], norm(x, p["ln2"]),
                          compute_dtype=compute_dtype), cache


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions=None, compute_dtype=torch.bfloat16,
            logits_last_only: bool = False) -> torch.Tensor:
    """tokens: (B, T) -> float32 logits (B, T, vocab_padded), or (B, 1,
    vocab_padded) with ``logits_last_only`` (serving prefill: the unembed of
    the last position only). The JAX function also returns an MoE aux; the
    port has no MoE layer, so it returns the logits alone."""
    check_supported(cfg)
    x = layers.embed(params["embed"], tokens).to(compute_dtype)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    for p, desc in zip(params["layers"], cfg.plan()):
        x = apply_layer(p, x, cfg, desc, positions=positions,
                        compute_dtype=compute_dtype)
    _, norm = layers.make_norm(cfg)
    if logits_last_only:
        x = x[:, -1:, :]
    x = norm(x, params["final_norm"])
    return layers.unembed(params["embed"], x, compute_dtype=compute_dtype,
                          n_valid=cfg.vocab)


# ---------------------------------------------------------------------------
# serving (single-token decode with caches)
# ---------------------------------------------------------------------------

class ServeState(NamedTuple):
    caches: tuple    # one KVCache / SSMState per layer, in layer order


def _init_cache_for(cfg, desc: LayerDesc, batch: int, max_len: int, *,
                    device, dtype, ring_cache: bool):
    if desc.kind == "attn":
        if ring_cache and desc.window is not None:
            max_len = min(max_len, desc.window)   # ring buffer
        return attn.init_cache(cfg, batch, max_len, device=device,
                               dtype=dtype)
    return ssm.init_state(cfg, batch, device=device, conv_dtype=dtype)


def init_serve(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               cache_dtype=torch.bfloat16,
               ring_cache: bool = False) -> ServeState:
    check_supported(cfg)
    dev = _device.resolve(device)
    return ServeState(tuple(
        _init_cache_for(cfg, d, batch, max_len, device=dev,
                        dtype=cache_dtype, ring_cache=ring_cache)
        for d in cfg.plan()))


def decode_step(params: dict, token: torch.Tensor, state: ServeState,
                cfg: ModelConfig, *, compute_dtype=torch.bfloat16):
    """token: (B, 1) int -> (logits (B, 1, vocab_padded) float32, new
    state). KV caches are updated in place (see ``models.attention``)."""
    x = layers.embed(params["embed"], token).to(compute_dtype)
    caches = []
    for p, desc, cache in zip(params["layers"], cfg.plan(), state.caches):
        x, cache = apply_layer_decode(p, x, cache, cfg, desc,
                                      compute_dtype=compute_dtype)
        caches.append(cache)
    _, norm = layers.make_norm(cfg)
    x = norm(x, params["final_norm"])
    logits = layers.unembed(params["embed"], x, compute_dtype=compute_dtype,
                            n_valid=cfg.vocab)
    return logits, ServeState(tuple(caches))
