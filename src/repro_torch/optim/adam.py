"""Adam/AdamW over dicts of tensors — port of ``repro.optim.adam``.

Used by GP hyperparameter MLE (``core/hyper.py``) and LM training
(``launch/train.py``: trees of dicts and lists). Supports global-norm
clipping, decoupled weight decay and schedule callables. The bias
corrections are computed in float32 from the step count, as the reference
computes them, so that float64 loss trajectories match it. The update runs
outside autograd (it is the optimizer, not part of the objective).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples (and over the matching leaves of ``rest``), keeping the
    structure; ``None`` (an LM's absent norm weights) stays ``None``. The
    port's optimizer, gradient compression and training step share it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


class AdamState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    """An LM's training state (``launch.train``; the reference's
    ``repro.launch.train.TrainState``)."""
    params: Any
    opt: AdamState
    ef: Any                # optim.compression.EFState | None
    step: torch.Tensor     # () int32


class Adam(NamedTuple):
    lr: float | Callable = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = None

    def init(self, params) -> AdamState:
        leaf = tree_leaves(params)[0]
        return AdamState(torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                         tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, *, gnorm=None):
        """One step; ``gnorm``, the gradients' global norm where the caller
        has it (a step over a mesh holds a shard of each gradient, so only
        it can say the whole tree's norm), is what clipping reads."""
        step = state.step + 1
        if self.clip_norm is not None:
            if gnorm is None:
                gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                      state.nu, grads)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                         device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                         device=t.device), t)
        lr = self.lr(step) if callable(self.lr) else self.lr

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return p - lr * u

        return tree_map(upd, params, mu, nu), AdamState(step, mu, nu)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Callable:
    def lr(step):
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr
