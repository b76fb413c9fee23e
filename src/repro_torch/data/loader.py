"""Deterministic, resumable LM batches and GP block sharding — port of
``repro.data.loader``.

``TokenLoader`` draws each batch from a ``torch.Generator`` seeded by
(seed, step) alone, so a loader restored to a step (``restore_state``, the
cursor a checkpoint keeps) gives the same batches as one that never
stopped. Host-free synthesis stands in for the storage layer, as in the
reference. Over a ``DeviceMesh`` each rank draws the global batch from the
same generator and keeps its rows by ``sharding.batch_spec``: the data
ranks' rows, concatenated in rank order, are the one-process batch.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.data import synthetic
from repro_torch.parallel import sharding as shd


class LoaderState(NamedTuple):
    step: int
    seed: int


class TokenLoader:
    """Synthetic LM token batches: "tokens" and "labels" (B, seq) int64,
    the labels the tokens shifted by one; an enc-dec config's "frames"
    (B, enc_seq, d_model) and a VLM's "inputs_embeds" (B, seq, d_model),
    both bfloat16 standard normal. ``batch`` is the global batch; over a
    ``mesh`` (a ``DeviceMesh``) each rank gets its rows of it, on its
    ``device``."""

    def __init__(self, cfg, mesh=None, *, batch: int, seq: int,
                 seed: int = 0, device=None):
        if not 0 <= seed < 2 ** 31:
            raise ValueError(f"seed must lie in [0, 2**31); got {seed}")
        self.cfg, self.mesh = cfg, mesh
        self.batch, self.seq = batch, seq
        self.device = _device.resolve(device)
        self.state = LoaderState(0, seed)
        if mesh is not None:
            self._rows = shd.Placement(shd.batch_spec(mesh), shd.axis_sizes(
                mesh))
            self._rows.local_shape((batch,))       # the rows must split
            self._coords = dict(zip(mesh.mesh_dim_names,
                                    mesh.get_coordinate()))

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
        if self.mesh is None:
            return batch
        return {k: self._rows.shard(x, self._coords).contiguous()
                for k, x in batch.items()}


def gp_blocks(ds: synthetic.Dataset, runner) -> tuple:
    """Standardize a GP dataset and block-shard it for a ``Runner``:
    (ds, this process's X blocks, its y blocks)."""
    ds = synthetic.standardize(ds)
    return ds, runner.shard_blocks(ds.X), runner.shard_blocks(ds.y)
