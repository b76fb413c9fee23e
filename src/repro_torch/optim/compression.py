"""Gradient compression with error feedback (an int8 1-bit-Adam-style
variant) — port of ``repro.optim.compression``.

Cross-worker traffic lives in a compressed space, the paper's systems
point (|S|² summaries instead of |D|² blocks) applied to data-parallel
training: gradients are quantized to int8 (one scale a tensor) before the
all-reduce, and the quantization error is fed back into the next step so
the bias telescopes away.

* ``compress_grads`` — the numerics alone (a simulation: the all-reduce
  itself still moves float32);
* ``compressed_psum`` — over the machine axis (``parallel.runner``): one
  ``pmax`` of the scale (``ReduceOp.MAX``), the int8 quantize, an int32
  all-reduce, the dequantize. 4x fewer bytes than float32 on the wire.

Gradients are trees (dicts, lists, tuples) of tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.adam import tree_leaves, tree_map


class EFState(NamedTuple):
    error: dict            # tree like grads


def init_ef(params) -> EFState:
    return EFState(tree_map(torch.zeros_like, params))


def _absmax(x: torch.Tensor) -> torch.Tensor:
    return x.abs().max()


def _quantize(x: torch.Tensor, absmax=_absmax):
    scale = torch.clamp(absmax(x), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q in float32 times the scale, in the scale's dtype if wider (as
    ``q.astype(float32) * scale`` promotes)."""
    dt = torch.promote_types(torch.float32, scale.dtype)
    return q.to(dt) * scale


def compress_grads(grads, ef: EFState, absmax=_absmax):
    """Quantize (with error feedback) each gradient leaf; returns
    (grads', ef'). ``absmax(x)`` gives a leaf's max |x|, whose 127th is its
    scale: by default over ``x``; a step over a mesh, whose ranks hold
    shards of a leaf, takes it over every shard."""
    g_l, e_l = tree_leaves(grads), tree_leaves(ef.error)
    deq, err = [], []
    for g, e in zip(g_l, e_l):
        corrected = g.to(torch.float32) + e
        q, scale = _quantize(corrected, absmax)
        d = _dequantize(q, scale).to(g.dtype)
        deq.append(d)
        err.append((g.to(torch.float32) + e
                    - d.to(torch.float32)).to(e.dtype))
    it_d, it_e = iter(deq), iter(err)
    return (tree_map(lambda _: next(it_d), grads),
            EFState(tree_map(lambda _: next(it_e), ef.error)))


def compressed_psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """int8-payload all-reduce over the machine axis ``axis_name`` (the
    runner's axis object) of x, this process's (L, ...) stack: agree on a
    shared scale (one scalar pmax), quantize, psum in int32, dequantize.
    Returns the (...) sum. Wire bytes: 1 an element plus one scalar."""
    ax = axis_name
    absmax = ax.pmax(x.abs().reshape(x.shape[0], -1).amax(1))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = ax.psum(q.to(torch.int32))
    return _dequantize(total, scale)
