"""Generic LM stack: decoder-only, hybrid SSM/attention, MoE interleaves and
encoder-decoder — port of ``repro.models.transformer``, driven by
``ModelConfig.layer_pattern``.

The JAX package stacks the layer parameters per pattern position and scans
over periods. The port keeps a flat list instead: ``params["layers"][i]`` is
layer i of ``cfg.plan()``, so stacked leaf ``[pos][i]`` of the reference is
layer ``i * period + pos``, and the remainder layers follow. An enc-dec
model's encoder is the list ``params["encoder"]`` (``enc_layers`` layers,
the reference's stacked leaf ``[i]``), and its precomputed cross K/V are one
(k, v) pair per decoder layer, in layer order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import LayerDesc, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm


class Aux(NamedTuple):
    moe_loss: torch.Tensor    # load-balance loss, mean over the MoE layers
    dropped: torch.Tensor     # dropped fraction, mean over the MoE layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, desc: LayerDesc, *,
               cross: bool = False, device, dtype=torch.float32) -> dict:
    norm_init, _ = layers.make_norm(cfg)
    p = {"ln1": norm_init(device), "ln2": norm_init(device)}
    if desc.kind == "attn":
        p["attn"] = attn.init_attn(gen, cfg, device=device, dtype=dtype)
    else:
        p["ssm"] = ssm.init_ssm(gen, cfg, device=device, dtype=dtype)
    if cross:
        p["ln_x"] = norm_init(device)
        p["cross"] = attn.init_attn(gen, cfg, cross=True, device=device,
                                    dtype=dtype)
    if desc.moe:
        p["moe"] = moe.init_moe(gen, cfg.d_model, cfg.moe_d_ff,
                                cfg.moe_experts, device=device, dtype=dtype)
    elif cfg.d_ff > 0:
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
    dev = _device.resolve(device)
    params = {
        "embed": layers.init_embed(generator, cfg.vocab_padded, cfg.d_model,
                                   cfg.tie_embeddings, device=dev,
                                   dtype=dtype),
        "layers": [init_layer(generator, cfg, desc, cross=cfg.enc_dec,
                              device=dev, dtype=dtype)
                   for desc in cfg.plan()],
    }
    norm_init, _ = layers.make_norm(cfg)
    params["final_norm"] = norm_init(dev)
    if cfg.enc_dec:
        enc_desc = LayerDesc(kind="attn")
        params["encoder"] = [init_layer(generator, cfg, enc_desc, device=dev,
                                        dtype=dtype)
                             for _ in range(cfg.enc_layers)]
        params["enc_norm"] = norm_init(dev)
    return params


# ---------------------------------------------------------------------------
# layer application (shared by prefill and decode)
# ---------------------------------------------------------------------------

def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
         compute_dtype, moe_groups: int = 1, rows=None):
    """The layer's FFN on its normed input: (y, MoEAux or None)."""
    if desc.moe:
        return moe.moe_ffn(p["moe"], h, top_k=cfg.moe_top_k,
                           capacity_factor=cfg.capacity_factor,
                           n_groups=moe_groups, dispatch=cfg.moe_dispatch,
                           compute_dtype=compute_dtype, rows=rows)
    return layers.mlp(p["mlp"], h, compute_dtype=compute_dtype), None


def apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, desc: LayerDesc,
                *, positions=None, enc_kv=None, causal: bool = True,
                moe_groups: int = 1, rows=None,
                compute_dtype=torch.bfloat16):
    """One layer of the full sequence: (x, MoEAux or None)."""
    _, norm = layers.make_norm(cfg)
    h = norm(x, p["ln1"])
    if desc.kind == "attn":
        h = attn.attend(p["attn"], h, cfg, window=desc.window,
                        positions=positions, causal=causal,
                        compute_dtype=compute_dtype)
    else:
        h = ssm.ssm_mixer(p["ssm"], h, cfg, compute_dtype=compute_dtype)
    x = x + h
    if enc_kv is not None and "cross" in p:
        x = x + attn.attend_cross(p["cross"], norm(x, p["ln_x"]), enc_kv,
                                  cfg, compute_dtype=compute_dtype)
    if "ln2" not in p:                       # pure-mixer block (no FFN)
        return x, None
    y, aux = _ffn(p, norm(x, p["ln2"]), cfg, desc, compute_dtype,
                  moe_groups, rows)
    return x + y, aux


def apply_layer_decode(p: dict, x: torch.Tensor, cache, cfg: ModelConfig,
                       desc: LayerDesc, *, enc_kv=None, cross_kv=None,
                       moe_groups: int = 1, compute_dtype=torch.bfloat16,
                       ops: "DecodeOps | None" = None):
    ops = ops or _ONE_PROCESS
    _, norm = layers.make_norm(cfg)
    h = norm(x, p["ln1"])
    if desc.kind == "attn":
        h, cache = ops.attend(p["attn"], h, cfg, cache, desc.window,
                              compute_dtype)
    else:
        h, cache = ops.ssm(p["ssm"], h, cfg, cache, compute_dtype)
    x = x + h
    if (enc_kv is not None or cross_kv is not None) and "cross" in p:
        x = x + ops.cross(p["cross"], norm(x, p["ln_x"]), cfg, enc_kv,
                          cross_kv, compute_dtype)
    if "ln2" not in p:
        return x, cache
    y, _ = _ffn(p, norm(x, p["ln2"]), cfg, desc, compute_dtype, moe_groups,
                ops.rows)
    return x + y, cache


# ---------------------------------------------------------------------------
# encoder and forward (prefill)
# ---------------------------------------------------------------------------

def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Encoder of an enc-dec model. ``frames``: the frontend's embeddings
    (B, Te, d), a stub in the reference too. Bidirectional self-attention
    with RoPE; the residual stream stays in ``frames``' dtype, as in the
    reference."""
    _, norm = layers.make_norm(cfg)
    x = frames
    for p in params["encoder"]:
        h = attn.attend(p["attn"], norm(x, p["ln1"]), cfg, causal=False,
                        compute_dtype=compute_dtype)
        x = x + h
        x = x + layers.mlp(p["mlp"], norm(x, p["ln2"]),
                           compute_dtype=compute_dtype)
    return norm(x, params["enc_norm"])


def forward(params: dict, tokens, cfg: ModelConfig, *, positions=None,
            enc_kv=None, inputs_embeds=None, compute_dtype=torch.bfloat16,
            remat: bool = False, remat_policy=None, moe_groups: int = 1,
            rows=None, logits_last_only: bool = False):
    """tokens: (B, T) -> (float32 logits (B, T, vocab_padded) (float64
    under a float64 ``compute_dtype``), Aux), or
    logits (B, 1, vocab_padded) with ``logits_last_only`` (serving prefill:
    the unembed of the last position only).

    ``inputs_embeds`` (B, T, d) replaces the token embedding (a VLM's patch
    embeddings; ``tokens`` is then not read); ``positions`` is (B, T), or
    (B, 3, T) (t, h, w) rows for M-RoPE; ``enc_kv`` is ``encode``'s output
    for the decoder's cross-attention. ``Aux`` holds the MoE layers' mean
    load-balance loss and dropped fraction (zeros without MoE layers).

    ``remat=True`` rematerializes each full period of ``cfg.layer_pattern``
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` over its period scan: the backward keeps only each
    period's input and runs the period's forward again. The remainder
    layers are not rematerialized, as in the reference. ``remat_policy``
    (JAX's ``checkpoint_policies``) has no counterpart and must be None.
    ``moe_groups`` is the MoE layers' routing-group count; ``rows`` the
    mesh axes the batch rows are split over (``moe.moe_ffn``: the MoE
    layers route the whole batch's groups)."""
    if remat_policy is not None:
        raise NotImplementedError(
            "remat_policy: JAX's checkpoint policies have no counterpart in "
            "the port; remat=True recomputes each whole period")
    x = (inputs_embeds if inputs_embeds is not None
         else layers.embed(params["embed"], tokens)).to(compute_dtype)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    plan = cfg.plan()
    zero = torch.zeros((), dtype=layers.wide(compute_dtype),
                       device=x.device)

    def run(first: int, n: int, x, loss, dropped):
        for i in range(first, first + n):
            x, aux = apply_layer(params["layers"][i], x, cfg, plan[i],
                                 positions=positions, enc_kv=enc_kv,
                                 moe_groups=moe_groups, rows=rows,
                                 compute_dtype=compute_dtype)
            if aux is not None:
                loss = loss + aux.load_balance_loss
                dropped = dropped + aux.dropped_fraction
        return x, loss, dropped

    period = cfg.period
    n_full = len(plan) // period * period
    loss, dropped = zero, zero
    for first in range(0, n_full, period):
        if remat:
            x, loss, dropped = checkpoint(run, first, period, x, loss,
                                          dropped, use_reentrant=False)
        else:
            x, loss, dropped = run(first, period, x, loss, dropped)
    x, loss, dropped = run(n_full, len(plan) - n_full, x, loss, dropped)
    _, norm = layers.make_norm(cfg)
    if logits_last_only:
        x = x[:, -1:, :]
    x = norm(x, params["final_norm"])
    logits = layers.unembed(params["embed"], x, compute_dtype=compute_dtype,
                            n_valid=cfg.vocab)
    n_moe = max(sum(d.moe for d in plan), 1)
    return logits, Aux(loss / n_moe, dropped / n_moe)


# ---------------------------------------------------------------------------
# serving (single-token decode with caches)
# ---------------------------------------------------------------------------

class ServeState(NamedTuple):
    caches: tuple         # one KVCache / SSMState per layer, in layer order
    enc_kv: object = None    # encoder output (enc-dec) or None
    cross_kv: object = None  # per-layer (k, v) from precompute_cross_kv


def _init_cache_for(cfg, desc: LayerDesc, batch: int, max_len: int, *,
                    device, dtype, ring_cache: bool):
    if desc.kind == "attn":
        if ring_cache and desc.window is not None:
            max_len = min(max_len, desc.window)   # ring buffer
        return attn.init_cache(cfg, batch, max_len, device=device,
                               dtype=dtype)
    return ssm.init_state(cfg, batch, device=device, conv_dtype=dtype)


def init_serve(cfg: ModelConfig, batch: int, max_len: int, *, enc_kv=None,
               device=None, cache_dtype=torch.bfloat16,
               ring_cache: bool = False) -> ServeState:
    dev = _device.resolve(device)
    return ServeState(tuple(
        _init_cache_for(cfg, d, batch, max_len, device=dev,
                        dtype=cache_dtype, ring_cache=ring_cache)
        for d in cfg.plan()), enc_kv)


def precompute_cross_kv(params: dict, enc_kv: torch.Tensor, cfg: ModelConfig,
                        compute_dtype=torch.bfloat16) -> tuple:
    """Every decoder layer's encoder K/V, once per request: attach with
    ``state._replace(cross_kv=..., enc_kv=None)`` and decode never projects
    the encoder's states again."""
    return tuple(attn.project_cross_kv(p["cross"], enc_kv, cfg,
                                       compute_dtype)
                 for p in params["layers"])


class DecodeOps:
    """The parts of ``decode_step`` that a step over a mesh replaces
    (``launch.serve.make_serve_step``): these are one process's. ``params``
    gives the tree the layer loop reads; ``rows`` names the mesh axes the
    batch rows are split over (``moe.moe_ffn``)."""
    rows = None

    def params(self, params: dict):
        return params

    def embed(self, params: dict, token: torch.Tensor, compute_dtype):
        return layers.embed(params["embed"], token).to(compute_dtype)

    def attend(self, p, h, cfg, cache, window, compute_dtype):
        return attn.attend_decode(p, h, cfg, cache, window=window,
                                  compute_dtype=compute_dtype)

    def ssm(self, p, h, cfg, state, compute_dtype):
        return ssm.ssm_decode(p, h, cfg, state, compute_dtype=compute_dtype)

    def cross(self, p, h, cfg, enc_kv, kv, compute_dtype):
        return attn.attend_cross(p, h, enc_kv, cfg,
                                 compute_dtype=compute_dtype, kv=kv)

    def unembed(self, params: dict, x: torch.Tensor, cfg, compute_dtype):
        return layers.unembed(params["embed"], x,
                              compute_dtype=compute_dtype, n_valid=cfg.vocab)


_ONE_PROCESS = DecodeOps()


def decode_step(params: dict, token: torch.Tensor, state: ServeState,
                cfg: ModelConfig, *, moe_groups: int = 1,
                compute_dtype=torch.bfloat16, ops: DecodeOps | None = None):
    """token: (B, 1) int -> (logits (B, 1, vocab_padded) float32, new
    state). KV caches are updated in place (see ``models.attention``). An
    enc-dec model attends over ``state.cross_kv`` when it is given, else
    projects ``state.enc_kv`` at every layer. ``moe_groups``: the MoE
    layers' routing groups over the B tokens. ``ops``: the step's parts,
    one process's by default."""
    ops = ops or _ONE_PROCESS
    x = ops.embed(params, token, compute_dtype)
    tree = ops.params(params)
    cross = state.cross_kv or (None,) * cfg.n_layers
    caches = []
    for p, desc, cache, ckv in zip(tree["layers"], cfg.plan(),
                                   state.caches, cross):
        x, cache = apply_layer_decode(p, x, cache, cfg, desc,
                                      enc_kv=state.enc_kv, cross_kv=ckv,
                                      moe_groups=moe_groups,
                                      compute_dtype=compute_dtype, ops=ops)
        caches.append(cache)
    _, norm = layers.make_norm(cfg)
    x = norm(x, tree["final_norm"])
    logits = ops.unembed(params, x, cfg, compute_dtype)
    return logits, ServeState(tuple(caches), state.enc_kv, state.cross_kv)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(params: dict, tokens, labels: torch.Tensor, cfg: ModelConfig, *,
            enc_kv=None, inputs_embeds=None, moe_loss_weight: float = 0.01,
            compute_dtype=torch.bfloat16, remat: bool = False,
            remat_policy=None, moe_groups: int = 1, rows=None):
    """Mean next-token cross-entropy over (B, T) ``labels`` (float32 log
    softmax over the padded vocabulary, whose padding columns are -1e30;
    float64 under a float64 ``compute_dtype``), plus ``moe_loss_weight``
    times the MoE load-balance loss. Returns (loss, Aux); the arguments are
    ``forward``'s."""
    logits, aux = forward(params, tokens, cfg, enc_kv=enc_kv,
                          inputs_embeds=inputs_embeds,
                          compute_dtype=compute_dtype, remat=remat,
                          remat_policy=remat_policy, moe_groups=moe_groups,
                          rows=rows)
    logp = F.log_softmax(logits.to(layers.wide(logits.dtype)), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(nll) + moe_loss_weight * aux.moe_loss, aux
