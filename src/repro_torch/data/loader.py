"""Deterministic, resumable LM batches and GP block sharding — port of
``repro.data.loader``.

``TokenLoader`` draws each batch from a ``torch.Generator`` seeded by
(seed, step) alone, so a loader restored to a step (``restore_state``, the
cursor a checkpoint keeps) gives the same batches as one that never
stopped. Host-free synthesis stands in for the storage layer, as in the
reference. Placing batches over a mesh's data axes is ROADMAP item 12b.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.data import synthetic


class LoaderState(NamedTuple):
    step: int
    seed: int


class TokenLoader:
    """Synthetic LM token batches on one device: "tokens" and "labels"
    (B, seq) int64, the labels the tokens shifted by one; an enc-dec
    config's "frames" (B, enc_seq, d_model) and a VLM's "inputs_embeds"
    (B, seq, d_model), both bfloat16 standard normal."""

    def __init__(self, cfg, mesh=None, *, batch: int, seq: int,
                 seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "TokenLoader over a mesh (batches placed on its data axes) "
                "is ROADMAP item 12b; pass mesh=None")
        if not 0 <= seed < 2 ** 31:
            raise ValueError(f"seed must lie in [0, 2**31); got {seed}")
        self.cfg = cfg
        self.batch, self.seq = batch, seq
        self.device = _device.resolve(device)
        self.state = LoaderState(0, seed)

    def save_state(self) -> dict:
        return {"step": self.state.step, "seed": self.state.seed}

    def restore_state(self, d: dict) -> None:
        self.state = LoaderState(int(d["step"]), int(d["seed"]))

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        step, seed = self.state
        gen = torch.Generator(device=self.device)
        gen.manual_seed((seed << 32) | (step & 0xFFFFFFFF))
        toks = synthetic.lm_tokens(gen, batch=self.batch, seq=self.seq,
                                   vocab=self.cfg.vocab)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        d = self.cfg.d_model
        if self.cfg.enc_dec:
            batch["frames"] = torch.randn(
                (self.batch, self.cfg.enc_seq, d), generator=gen,
                device=self.device).to(torch.bfloat16)
        if self.cfg.family == "vlm":
            batch["inputs_embeds"] = torch.randn(
                (self.batch, self.seq, d), generator=gen,
                device=self.device).to(torch.bfloat16)
        self.state = LoaderState(step + 1, seed)
        return batch


def gp_blocks(ds: synthetic.Dataset, runner) -> tuple:
    """Standardize a GP dataset and block-shard it for a ``Runner``:
    (ds, this process's X blocks, its y blocks)."""
    ds = synthetic.standardize(ds)
    return ds, runner.shard_blocks(ds.X), runner.shard_blocks(ds.y)
