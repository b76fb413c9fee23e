"""LM serving — port of ``repro.launch.serve``: the generation loop
``prefill_then_decode`` (which also serves an enc-dec model given its
encoder's output, over cross K/V projected once), and the decode step over
a ``DeviceMesh`` (``serve_state_specs``, ``make_serve_step``).

The reference leaves the sharded step's collectives to GSPMD; here they
are explicit (``parallel.sharding.MeshAxes``). A rank holds its chunks of
the parameters and of the serve state, and never gathers a cache:

- batch rows on the data axes: each rank decodes its own rows;
- KV heads on "model": each rank attends with its KV heads and their
  query heads, then the heads' outputs are all-gathered over "model"
  before ``wo``; an SSM's heads likewise, gathered before ``out_proj``;
- a vocabulary split over "model" (the embedding table's rows, and the
  logits' columns by ``logits_spec``): each rank looks up the tokens in its
  rows (the others' sum in rank order adds zeros) and computes its columns
  of the logits;
- batch 1 (long context): the cache's positions on the data axes. The
  rank that holds position ``length`` writes the new K/V; each attends
  over its own positions and returns its output and log-sum-exp (the
  running max m and sum l in one number), which are combined over the
  data axes in rank order.

The other parameters are all-gathered layer by layer as the step reads
them, and each other product is computed in full (sharded storage,
gathered compute).
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as shd


def prefill_then_decode(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                        *, max_len: int, n_decode: int,
                        temperature: float = 0.0,
                        generator: torch.Generator | None = None,
                        step_ms: list | None = None,
                        enc_kv: torch.Tensor | None = None) -> torch.Tensor:
    """Reference generation loop: the prompt goes through decode steps one
    token at a time (simple and exact, as in the reference), then
    ``n_decode`` tokens are chosen greedily, or sampled at ``temperature``
    from ``generator`` when both are given. bfloat16 compute and caches, the
    reference's defaults. Returns (B, T + n_decode).

    ``enc_kv``: an enc-dec model's encoder output (``transformer.encode``);
    every decoder layer's cross K/V are projected from it once
    (``precompute_cross_kv``) and every step attends over them.

    ``step_ms``: when a list is given, each generated token's step (choose
    the token, then the decode step) is synchronised with the device and
    its wall time in milliseconds appended to it. Per-token latency is what
    a caller of generation feels, and only this loop knows where one
    token's step begins and ends, so the measurement lives here rather
    than in a copy of the loop; without ``step_ms`` the loop makes no
    device sync.
    """
    B, T = tokens.shape
    if T + n_decode > max_len:
        raise ValueError(f"prompt {T} + {n_decode} new tokens exceed "
                         f"max_len {max_len}")
    state = tf.init_serve(cfg, B, max_len, device=tokens.device)
    if enc_kv is not None:
        state = state._replace(cross_kv=tf.precompute_cross_kv(params,
                                                               enc_kv, cfg))
    logits = None
    for t in range(T):
        logits, state = tf.decode_step(params, tokens[:, t:t + 1], state, cfg)
    out = [tokens]
    for _ in range(n_decode):
        if step_ms is not None:
            _sync(tokens.device)
            t0 = time.perf_counter()
        last = logits[:, -1]
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(last / temperature, dim=-1)
            cur = torch.multinomial(probs, 1, generator=generator)
        else:
            cur = torch.argmax(last, dim=-1, keepdim=True)
        out.append(cur.to(tokens.dtype))
        logits, state = tf.decode_step(params, cur, state, cfg)
        if step_ms is not None:
            _sync(tokens.device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return torch.cat(out, dim=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_state_specs(cfg: ModelConfig, mesh, *, batch: int) -> tf.ServeState:
    """A tree shaped like ``transformer.init_serve``'s state of ``batch``
    rows (flat, a cache a layer) of specs, by the reference's rule without
    its stacked axis: KV caches by ``cache_spec``, SSM states by
    ``ssm_state_spec`` and their conv states split on the batch where it
    divides, an enc-dec model's ``cross_kv`` by ``cache_spec`` over the
    encoder's positions. ``enc_kv`` is ``None``: the step takes the cross
    K/V precomputed."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H_ssm = d_inner // cfg.ssm_headdim if cfg.ssm_state else 1
    sizes, dpx = shd.axis_sizes(mesh), shd._dpx(mesh)
    bshard = dpx if (batch > 1 and batch % max(1, shd._size(sizes, dpx))
                     == 0) else None

    def cache_specs(desc):
        if desc.kind == "attn":
            kv = shd.cache_spec(mesh, batch=batch, n_kv=cfg.n_kv_heads,
                                seq=cfg.max_seq, stacked=False)
            return attn.KVCache(kv, kv, ())
        return ssm.SSMState(shd.ssm_state_spec(mesh, batch=batch,
                                               n_heads=H_ssm, stacked=False),
                            (bshard, None, None))

    caches = tuple(cache_specs(d) for d in cfg.plan())
    if not cfg.enc_dec:
        return tf.ServeState(caches, None, None)
    kv = shd.cache_spec(mesh, batch=batch, n_kv=cfg.n_kv_heads,
                        seq=cfg.enc_seq, stacked=False)
    return tf.ServeState(caches, None, tuple((kv, kv) for _ in cfg.plan()))


def make_serve_step(cfg: ModelConfig, mesh, *, batch: int,
                    compute_dtype=torch.bfloat16):
    """(step, built), as the reference returns them. ``step(params, token,
    state)`` is ``transformer.decode_step``. ``built(params)`` (the full
    parameters, or any tree of their shapes: the specs come from them)
    gives ``sharded(params, token, state) -> (logits, state)`` over
    ``mesh``: ``decode_step`` with ``_MeshOps``, over this rank's chunks of
    the parameters (``param_specs``) and of the state
    (``serve_state_specs``; ``sharding.local_shards``), its token rows (its
    rows of the batch where the caches split it, else all ``batch``), and
    its chunk of the logits by ``logits_spec``. Each rank of the mesh calls
    it. Ring-buffer caches split over positions are not supported."""

    def step(params, token, state):
        return tf.decode_step(params, token, state, cfg,
                              compute_dtype=compute_dtype)

    def built(params_like):
        ops = _MeshOps(cfg, mesh, shd.param_specs(params_like, mesh), batch)

        def sharded(params, token, state):
            return tf.decode_step(params, token, state, cfg,
                                  compute_dtype=compute_dtype, ops=ops)
        return sharded

    return step, built


class _MeshOps(tf.DecodeOps):
    """``decode_step``'s parts over a mesh (see the module docstring). The
    splits are read from ``serve_state_specs`` and ``logits_spec``, the
    specs the state and the logits are placed by."""

    def __init__(self, cfg, mesh, pspec, batch: int):
        self.cfg, self.pspec = cfg, pspec
        self.axes = axes = shd.MeshAxes(mesh)
        sizes = axes.sizes
        caches = serve_state_specs(cfg, sizes, batch=batch).caches
        kv = next((c.k for c in caches if isinstance(c, attn.KVCache)),
                  None)
        state = next((c.ssm for c in caches if isinstance(c, ssm.SSMState)),
                     None)

        def split(spec, dim):
            """The ranks a state's axis ``dim`` is split over, or None."""
            names = shd.entry_axes(spec[dim]) if spec else ()
            return axes.group(names) if shd._size(sizes, names) > 1 \
                else None

        self.rows = split(kv or state, 0)
        self.seq = split(kv, 2)
        self.kv_split = split(kv, 1) is not None
        self.ssm_split = split(state, 1) is not None
        self.tp = axes.coords.get(shd.TP, 0)
        self.vocab = (None, None, shd.logits_spec(
            sizes, batch=batch, vocab=cfg.vocab_padded)[2])
        espec = pspec["embed"]
        self.vocab_split = (
            sizes.get(shd.TP, 1) > 1 and self.vocab[2] == shd.TP
            and espec["tok"][0] == shd.TP
            and ("unembed" not in espec or espec["unembed"][1] == shd.TP))
        if self.kv_split:
            m = sizes[shd.TP]
            self.cfg_heads = cfg.scaled(n_heads=cfg.n_heads // m,
                                        n_kv_heads=cfg.n_kv_heads // m)
        else:
            self.cfg_heads = cfg

    def params(self, params: dict):
        """Each leaf all-gathered where the step reads it."""
        return shd.gather_on_use(params, self.pspec, self.axes)

    def _heads(self, p) -> dict:
        """A layer's attention parameters, gathered, cut to this rank's
        heads."""
        p = dict(p)
        if not self.kv_split:
            return p
        c, hd = self.cfg_heads, self.cfg.head_dim
        q, kv = c.n_heads * hd, c.n_kv_heads * hd
        p["wq"] = p["wq"][:, self.tp * q:(self.tp + 1) * q]
        for k in ("wk", "wv"):
            p[k] = p[k][:, self.tp * kv:(self.tp + 1) * kv]
        return p

    def _model_cat(self, o: torch.Tensor, split: bool) -> torch.Tensor:
        """Every "model" rank's heads (dim 1), in rank order."""
        return self.axes.gather(o, (None, shd.TP)) if split else o

    def _combine(self, o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The attention over every data rank's positions from each rank's
        output ``o`` over its own and their log-sum-exp ``lse``: weights
        exp(lse_r - max), summed in rank order."""
        spec = (self.seq.names,)
        outs = self.axes.gather(o[None], spec)
        lses = self.axes.gather(lse[None], spec)
        wd = lses.dtype
        w = torch.exp(lses - lses.max(dim=0).values)
        total, acc = w[0], w[0][..., None] * outs[0].to(wd)
        for r in range(1, outs.shape[0]):
            total = total + w[r]
            acc = acc + w[r][..., None] * outs[r].to(wd)
        return (acc / total[..., None]).to(o.dtype)

    def _seq_attend(self, q, cache: attn.KVCache, n: int, window, causal):
        """This rank's attention over its positions, combined over the data
        axes."""
        Tl = cache.k.shape[2]
        s0 = self.seq.index * Tl
        if causal and n < s0:                   # no position of ours yet
            o = torch.zeros_like(q)
            lse = torch.full(q.shape[:3], -torch.inf,
                             dtype=layers.wide(q.dtype), device=q.device)
        else:
            o, lse = attn_ops.attention_with_lse(
                q, cache.k, cache.v, causal=causal, window=window,
                q_offset=n - s0 if causal else 0)
        return self._combine(o, lse)

    def attend(self, p, h, cfg, cache: attn.KVCache, window, cd):
        c, ph = self.cfg_heads, self._heads(p)
        if self.seq is None:
            o, cache = attn.decode_heads(ph, h, c, cache, window=window,
                                         compute_dtype=cd)
        else:
            n, Tl = cache.length, cache.k.shape[2]
            if window is not None and Tl * self.seq.size == window:
                raise NotImplementedError(
                    "a ring-buffer cache split over positions")
            if n >= Tl * self.seq.size:
                raise ValueError(f"KV cache of {Tl * self.seq.size} slots "
                                 f"is full (length {n})")
            pos = torch.full((h.shape[0], 1), n, dtype=torch.long,
                             device=h.device)
            q, k_new, v_new = attn._project(ph, h, c, cd)
            q, k_new = attn._rope(q, k_new, pos, c)
            owner, slot = divmod(n, Tl)
            if owner == self.seq.index:
                cache.k[:, :, slot] = k_new[:, :, 0].to(cache.k.dtype)
                cache.v[:, :, slot] = v_new[:, :, 0].to(cache.v.dtype)
            o = self._seq_attend(q, cache, n, window, True)
            cache = attn.KVCache(cache.k, cache.v, n + 1)
        o = self._model_cat(o, self.kv_split)
        return attn._merge(o, ph, h, cd), cache

    def cross(self, p, h, cfg, enc_kv, kv, cd):
        if kv is None:
            raise ValueError("the step over a mesh takes an enc-dec model's "
                             "cross K/V precomputed (state.cross_kv, "
                             "transformer.precompute_cross_kv)")
        ph = self._heads(p)
        q = attn.cross_query(ph, h, self.cfg_heads, cd)
        if self.seq is not None:
            o = self._seq_attend(q, attn.KVCache(*kv, 0), 0, None, False)
        else:
            o = attn_ops.attention(q, *kv, causal=False)
        return attn._merge(self._model_cat(o, self.kv_split), ph, h, cd)

    def ssm(self, p, h, cfg, state: ssm.SSMState, cd):
        p, heads = dict(p), slice(None)
        if self.ssm_split:
            n = state.ssm.shape[1]
            heads = slice(self.tp * n, (self.tp + 1) * n)
        y, z, state = ssm.decode_heads(p, h, cfg, state, cd, heads)
        y = self._model_cat(y, self.ssm_split)
        y = y.reshape(h.shape[0], 1, -1).to(cd)
        return ssm._gate_out(p, y, z, cfg, h, cd), state

    def embed(self, params: dict, token: torch.Tensor, cd):
        if not self.vocab_split:
            return super().embed(self.params(params), token, cd)
        tok = self._rows_of("tok", params["embed"]["tok"], 0)   # (V / M, d)
        n = tok.shape[0]
        ids = token - self.tp * n
        mine = (ids >= 0) & (ids < n)
        x = torch.where(mine[..., None], tok[ids.clamp(0, n - 1)], 0)
        return self.axes.sum(x, (shd.TP,)).to(cd)

    def unembed(self, params: dict, x: torch.Tensor, cfg, cd):
        if not self.vocab_split:
            logits = super().unembed(self.params(params), x, cfg, cd)
            return self.axes.shard(logits, self.vocab)
        embed = params["embed"]
        if "unembed" in embed:
            w = self._rows_of("unembed", embed["unembed"], 1)
        else:
            w = self._rows_of("tok", embed["tok"], 0).T
        logits = layers.matmul(x, w, cd).to(layers.wide(cd))
        start = self.tp * w.shape[1]
        if cfg.vocab < start + w.shape[1]:    # padding columns
            logits[..., max(cfg.vocab - start, 0):] = -1e30
        return logits

    def _rows_of(self, name: str, t: torch.Tensor, dim: int):
        """This rank's vocabulary chunk of an embedding leaf, gathered
        over its other split."""
        spec = list(self.pspec["embed"][name])
        spec[dim] = None
        return self.axes.gather(t, tuple(spec))
