"""Meta-device input stand-ins for every (arch x shape) dry-run cell —
port of ``repro.launch.specs``: the reference's ``ShapeDtypeStruct``s
become tensors on the ``meta`` device (shapes and dtypes, no data, no
allocation).

Tokens and labels are int64, the port's token dtype (``data/synthetic.py``,
``data/loader.py``), where the reference's are int32; ``inputs_embeds``
and ``frames`` are bfloat16 in both.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeSpec

TOKEN_DTYPE = torch.int64
EMBED_DTYPE = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, T = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, T), TOKEN_DTYPE),
             "labels": _meta((B, T), TOKEN_DTYPE)}
    if cfg.family == "vlm":
        # frontend stub: precomputed patch embeddings replace token embeds
        specs["inputs_embeds"] = _meta((B, T, cfg.d_model), EMBED_DTYPE)
    if cfg.enc_dec:
        # frontend stub: precomputed audio frame embeddings
        specs["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), EMBED_DTYPE)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return {"token": _meta((shape.global_batch, 1), TOKEN_DTYPE)}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    shape = SHAPES[shape_name]
    if shape.kind == "train" or shape.kind == "prefill":
        return train_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
