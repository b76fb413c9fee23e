"""Architecture registry: --arch <id> -> ModelConfig, plus reduced smoke
configs for CPU tests."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_coder_33b, gemma3_4b, jamba_1p5_large,
                           mamba2_130m, mixtral_8x22b, olmo_1b, qwen2_vl_72b,
                           qwen3_1p7b, qwen3_moe_30b_a3b, whisper_medium)
from repro_torch.configs.base import ModelConfig

_MODULES = (mixtral_8x22b, qwen3_moe_30b_a3b, qwen2_vl_72b, mamba2_130m,
            gemma3_4b, qwen3_1p7b, deepseek_coder_33b, olmo_1b,
            whisper_medium, jamba_1p5_large)

REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                    for m in _MODULES}
ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab —
    one full pattern period (+1 remainder layer when the full model has one)
    so heterogeneous stacks exercise both the scan and the remainder path."""
    cfg = get_config(name)
    period = cfg.period
    n_layers = period + (1 if cfg.n_layers % period else 0)
    n_layers = max(n_layers, 2)
    heads = 4 if cfg.n_heads else 0
    kv = min(max(cfg.n_kv_heads and 2, 0), heads) if cfg.n_kv_heads else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if heads else 1,
        d_ff=0 if cfg.d_ff == 0 else 128,
        moe_d_ff=128 if cfg.moe_experts else 0,
        vocab=256,
        moe_experts=4 if cfg.moe_experts else 0,
        moe_top_k=2 if cfg.moe_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        enc_layers=2 if cfg.enc_dec else 0,
        enc_seq=24 if cfg.enc_dec else cfg.enc_seq,
        mrope_sections=(4, 2, 2) if cfg.mrope else cfg.mrope_sections,
        max_seq=128,
    )
