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
batch)`` runs on the state's device. ``on_mesh(state)`` gives the step over
a ``DeviceMesh`` (``launch.mesh.make_mesh``), the counterpart of the
reference's sharded, jitted step: ``step(local_state, local_batch)`` on
each rank, the state's leaves its chunks by ``state_specs``
(``sharding.local_shards``), the batch its rows by ``sharding.batch_spec``
(``data.loader.TokenLoader(cfg, mesh)``). It computes the one-process
step's function, with the same ``moe_groups``:

- each layer's parameters are all-gathered where the layer reads them,
  and again where remat recomputes it (``sharding.gather_on_use``); the
  others (the embedding, the final norms) once a forward; each gradient
  is summed over the batch's axes in rank order and cut back to the
  rank's chunk (the ranks along "model" hold the same rows and are not
  summed);
- each rank's loss is its rows' mean over the number of batch ranks, so
  the gradients sum to the global mean's; the loss reported is their sum;
- an MoE layer routes the whole batch's groups (``moe.moe_ffn(rows=)``);
  with microbatches the ranks first regroup the batch so that each holds
  its share of every one-process microbatch;
- the global norm counts each distinct chunk once; compression takes each
  stacked leaf's scale as the max over every chunk (an all-reduce of the
  max); Adam runs on the chunks.

The "model" axis is sharded storage with gathered compute: each rank
computes every product in full on the gathered parameters. Megatron-style
tensor-parallel products (each rank its columns or rows, an all-reduce of
partial sums) are later performance work (ROADMAP item 15).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.optim import compression
from repro_torch.optim.adam import (Adam, AdamState, TrainState,
                                    tree_leaves, tree_map)
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
                    remat_policy=None, compress: bool = False,
                    moe_groups: int = 1, compute_dtype=torch.bfloat16):
    """(train_step, on_mesh); see the module docstring. ``batch`` holds
    "tokens" and "labels" (B, T), and "frames" (enc-dec) or
    "inputs_embeds" (VLM) as ``data.loader.TokenLoader`` makes them; B must
    divide by ``microbatches``. ``moe_groups``: the MoE layers' routing
    groups over a microbatch's tokens; ``compute_dtype``: ``lm_loss``'s and
    ``encode``'s (the reference's step has none: it runs their bfloat16
    default)."""

    def loss_fn(params, batch, rows=None):
        enc_kv = batch.get("enc_kv")
        if cfg.enc_dec and "frames" in batch:
            enc_kv = tf.encode(params, batch["frames"], cfg,
                               compute_dtype=compute_dtype)
        return tf.lm_loss(params, batch.get("tokens"), batch["labels"], cfg,
                          enc_kv=enc_kv,
                          inputs_embeds=batch.get("inputs_embeds"),
                          remat=remat, remat_policy=remat_policy,
                          moe_groups=moe_groups, rows=rows,
                          compute_dtype=compute_dtype)

    def accumulate(loss_fn, params, batch, device):
        """(loss, aux, grads) of the batch, summed over microbatches and
        times 1 / microbatches, as the reference accumulates them."""
        if microbatches == 1:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
            return loss, aux, grads

        def mb_slice(i):
            return {k: x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))[i]
                    for k, x in batch.items()}

        grads = tree_map(torch.zeros_like, params)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        loss = moe_l = drop = zero
        for i in range(microbatches):
            (l, a), g = value_and_grad(loss_fn, params, mb_slice(i))
            grads = tree_map(torch.Tensor.add_, grads, g)
            loss, moe_l = loss + l, moe_l + a.moe_loss
            drop = drop + a.dropped
            del g
        inv = 1.0 / microbatches
        grads = tree_map(lambda g: g * inv, grads)
        return loss * inv, tf.Aux(moe_l * inv, drop * inv), grads

    def finish(state: TrainState, loss, aux, grads, *,
               absmax=compression._absmax, norm=_norm):
        ef = state.ef
        if compress and ef is not None:
            g, e = compression.compress_grads(
                _stacked(grads, cfg),
                compression.EFState(_stacked(ef.error, cfg)), absmax)
            grads, ef = _flat(g, cfg), compression.EFState(
                _flat(e.error, cfg))
        gnorm = norm(grads)
        params, opt_state = opt.update(grads, state.opt, state.params,
                                       gnorm=gnorm)
        new_state = TrainState(params, opt_state, ef, state.step + 1)
        return new_state, Metrics(loss, aux.moe_loss, aux.dropped, gnorm)

    def train_step(state: TrainState, batch: dict):
        loss, aux, grads = accumulate(loss_fn, state.params, batch,
                                      state.step.device)
        return finish(state, loss, aux, grads)

    def on_mesh(state: TrainState):
        """The step over ``mesh`` for a state shaped like ``state`` (its
        full shapes: the specs come from them; the leaves may lie on the
        ``meta`` device). Each rank of the mesh calls it. ``mesh`` may
        also be a ``MeshAxes`` (``sharding.mesh_axes``), as the dry-run
        passes its recording axes."""
        if mesh is None:
            raise ValueError("on_mesh needs a mesh: make_train_step was "
                             "given none (mesh=None)")
        specs = state_specs(state, mesh)
        axes = shd.mesh_axes(mesh)
        rows = axes.group(shd.batch_axes(mesh))
        R = rows.size

        def gather(spec, t):
            return shd.gather_grad(t, axes, spec, rows.names)

        def local_loss(local_params, batch):
            # a layer's parameters where the layer reads them; the rest
            # (the embedding, read twice when tied, and the final norms)
            # once a forward
            view = shd.gather_on_use(local_params, specs.params, axes,
                                     rows.names)
            params = {k: view[k] if k in ("layers", "encoder") else
                      shd.map_specs(gather, specs.params[k], v)
                      for k, v in local_params.items()}
            loss, aux = loss_fn(params, batch, rows if R > 1 else None)
            return (loss / R if R > 1 else loss), aux

        def regroup(batch):
            """Each rank's share of every one-process microbatch: global
            rows i B / mb + r B / (mb R) + j of microbatch i."""
            out = {}
            for k, x in batch.items():
                full = axes.gather(x, (rows.names,))
                b = full.shape[0] // (microbatches * R)
                out[k] = full.reshape((microbatches, R, b)
                                      + tuple(x.shape[1:]))[:, rows.index] \
                    .reshape(tuple(x.shape))
            return out

        def step(state: TrainState, batch: dict):
            if R > 1 and microbatches > 1:
                batch = regroup(batch)
            loss, aux, grads = accumulate(local_loss, state.params, batch,
                                          state.step.device)
            if R > 1:
                loss = axes.sum(loss, rows.names)
            return finish(state, loss, aux, grads,
                          absmax=lambda x: axes.max(x.abs().max()),
                          norm=lambda g: _norm(g, specs.params, axes))

        return step

    return train_step, on_mesh


def _norm(grads, specs=None, axes: shd.MeshAxes | None = None):
    """``global_norm``, in float64 for float64 gradients. Over a mesh
    (``axes``, the grads a tree of chunks laid out by ``specs``), each
    leaf's sum of squares is summed over the axes its spec splits (a
    replicated chunk counted once), one sum a set of axes; the leaves are
    added in tree order."""
    if axes is None:
        pairs = [((), g) for g in tree_leaves(grads)]
    else:
        pairs = []
        shd.map_specs(lambda spec, g: pairs.append((spec, g)), specs, grads)
    sq = [torch.sum(torch.square(g.to(layers.wide(g.dtype))))
          for _, g in pairs]
    split = [() if axes is None else
             axes.live(a for e in spec for a in shd.entry_axes(e))
             for spec, _ in pairs]
    for names in dict.fromkeys(s for s in split if s):   # in tree order
        idx = [i for i, s in enumerate(split) if s == names]
        tot = axes.sum(torch.stack([sq[i] for i in idx]), names)
        for j, i in enumerate(idx):
            sq[i] = tot[j]
    return torch.sqrt(sum(sq))
