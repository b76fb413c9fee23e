"""The LM training step — port of ``repro.launch.train`` on one device.

A step: ``lm_loss`` through ``forward`` (each period rematerialized when
``remat``), the backward through the flash and SSD backward kernels on the
card, gradients accumulated over microbatches in the reference's order
(their sum, then times 1 / microbatches), optional int8 compression with
error feedback (``optim.compression``), the global norm, then the Adam(W)
update. An enc-dec batch with "frames" is encoded first, inside the loss,
as the reference does.

Compression quantizes with one scale a leaf of the reference's stacked
layout, as the reference does: the layers at one position of
``cfg.layer_pattern`` share a leaf's scale (the remainder layers have
their own, the encoder's layers share one), so the step's gradients are
stacked that way for ``compress_grads`` and taken apart after it.

``make_train_step`` returns ``(train_step, on_mesh)``. ``train_step(state,
batch)`` runs on the state's device. ``on_mesh`` stands for the
reference's sharded, jitted step: a step executed over a
``DeviceMesh`` by ``state_specs`` is ROADMAP item 12b, and it raises.
``state_specs`` gives the layouts already (``parallel.sharding``'s rules).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import compression
from repro_torch.optim.adam import (Adam, AdamState, TrainState,
                                    global_norm, tree_leaves, tree_map)
from repro_torch.parallel import sharding as shd


class Metrics(NamedTuple):
    loss: torch.Tensor
    moe_loss: torch.Tensor
    dropped: torch.Tensor
    grad_norm: torch.Tensor


def init_state(cfg: ModelConfig, opt: Adam, *, generator: torch.Generator,
               device=None, compress: bool = False) -> TrainState:
    """Random float32 parameters (``transformer.init_model``), Adam's zero
    moments, zero error feedback when ``compress``, step 0; on the card
    unless ``device`` names another (``generator`` lives there)."""
    dev = _device.resolve(device)
    params = tf.init_model(cfg, generator=generator, device=dev)
    ef = compression.init_ef(params) if compress else None
    return TrainState(params, opt.init(params), ef,
                      torch.zeros((), dtype=torch.int32, device=dev))


def state_specs(state: TrainState, mesh) -> TrainState:
    """The state's layouts over ``mesh`` (``parallel.sharding`` specs):
    parameters, both moments and the error feedback by the parameter
    rules; the steps replicated (``()``)."""
    pspec = shd.param_specs(state.params, mesh)
    ef = compression.EFState(pspec) if state.ef is not None else None
    return TrainState(pspec, AdamState((), pspec, pspec), ef, ())


def value_and_grad(loss_fn, params, batch):
    """(loss, aux), and the gradients of ``loss`` w.r.t. every tensor leaf
    of ``params`` (zeros where the loss does not reach a leaf)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    (loss, aux) = loss_fn(leaves, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t)
              for g, t in zip(grads, flat))
    return (loss.detach(), tf.Aux(*(a.detach() for a in aux))), \
        tree_map(lambda _: next(it), params)


def _stacked(tree: dict, cfg: ModelConfig) -> dict:
    """The port's flat-layer tree in the reference's layout: ``stack[pos]``
    holds the leaves of layers pos, pos + period, ... stacked on a leading
    axis, ``rest`` the remainder layers, ``encoder`` the encoder's layers
    stacked."""
    period = cfg.period
    n_full = cfg.n_layers // period
    layers = tree["layers"]
    stack = lambda group: tree_map(lambda *ts: torch.stack(ts), *group)
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    out["stack"] = [stack([layers[i * period + pos] for i in range(n_full)])
                    for pos in range(period if n_full else 0)]
    out["rest"] = layers[n_full * period:]
    if "encoder" in tree:
        out["encoder"] = stack(tree["encoder"])
    return out


def _flat(tree: dict, cfg: ModelConfig) -> dict:
    """``_stacked``'s inverse, keys in ``transformer.init_model``'s
    order."""
    period = cfg.period
    n_full = cfg.n_layers // period
    out = dict(tree)
    stack, rest = out.pop("stack"), out.pop("rest")
    out["layers"] = [tree_map(lambda t: t[i], stack[pos])
                     for i in range(n_full) for pos in range(period)]
    out["layers"] += rest
    if "encoder" in tree:
        out["encoder"] = [tree_map(lambda t: t[i], tree["encoder"])
                          for i in range(cfg.enc_layers)]
    order = ("embed", "layers", "final_norm", "encoder", "enc_norm")
    return {k: out[k] for k in sorted(out, key=order.index)}


def make_train_step(cfg: ModelConfig, mesh, opt: Adam, *,
                    microbatches: int = 1, remat: bool = True,
                    remat_policy=None, compress: bool = False):
    """(train_step, on_mesh); see the module docstring. ``batch`` holds
    "tokens" and "labels" (B, T), and "frames" (enc-dec) or
    "inputs_embeds" (VLM) as ``data.loader.TokenLoader`` makes them; B must
    divide by ``microbatches``."""

    def loss_fn(params, batch):
        enc_kv = batch.get("enc_kv")
        if cfg.enc_dec and "frames" in batch:
            enc_kv = tf.encode(params, batch["frames"], cfg)
        return tf.lm_loss(params, batch.get("tokens"), batch["labels"], cfg,
                          enc_kv=enc_kv,
                          inputs_embeds=batch.get("inputs_embeds"),
                          remat=remat, remat_policy=remat_policy)

    def train_step(state: TrainState, batch: dict):
        if microbatches == 1:
            (loss, aux), grads = value_and_grad(loss_fn, state.params, batch)
        else:
            def mb_slice(i):
                return {k: x.reshape((microbatches,
                                      x.shape[0] // microbatches)
                                     + tuple(x.shape[1:]))[i]
                        for k, x in batch.items()}

            grads = tree_map(torch.zeros_like, state.params)
            zero = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            loss = moe_l = drop = zero
            for i in range(microbatches):
                (l, a), g = value_and_grad(loss_fn, state.params,
                                            mb_slice(i))
                grads = tree_map(torch.Tensor.add_, grads, g)
                loss, moe_l = loss + l, moe_l + a.moe_loss
                drop = drop + a.dropped
                del g
            inv = 1.0 / microbatches
            grads = tree_map(lambda g: g * inv, grads)
            loss, aux = loss * inv, tf.Aux(moe_l * inv, drop * inv)

        ef = state.ef
        if compress and ef is not None:
            g, e = compression.compress_grads(
                _stacked(grads, cfg),
                compression.EFState(_stacked(ef.error, cfg)))
            grads, ef = _flat(g, cfg), compression.EFState(
                _flat(e.error, cfg))
        gnorm = global_norm(grads)
        params, opt_state = opt.update(grads, state.opt, state.params)
        new_state = TrainState(params, opt_state, ef, state.step + 1)
        return new_state, Metrics(loss, aux.moe_loss, aux.dropped, gnorm)

    def on_mesh(state: TrainState):
        raise NotImplementedError(
            "a train step executed over a DeviceMesh (the reference's "
            "sharded, jitted step) is ROADMAP item 12b; state_specs gives "
            "its layouts")

    return train_step, on_mesh
