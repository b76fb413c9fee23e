"""The port's encoder-decoder and VLM-input paths on the CPU against the JAX
package, at smoke widths: whisper-medium (``encode``, ``forward(enc_kv)``,
``precompute_cross_kv``, decode steps over the encoder's output and over
precomputed cross K/V, greedy generation against the reference's enc-dec
loop of ``examples/lm_serve.py``) and qwen2-vl-72b (``inputs_embeds`` with
(B, 3, T) M-RoPE positions). The JAX model's weights are carried across by
``convert.lm_params_from_arrays``, inputs are made with numpy from a seed,
and both packages compute in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import transformer as tf

B, T = 2, 16
F32 = torch.float32
# Both packages run the same float32 graph on the same weights and differ
# in summation order only (test_torch_lm.py).
TOL_F32 = 1e-4

_jencode = jax.jit(jtf.encode, static_argnames=("cfg", "compute_dtype"))
_jforward = jax.jit(jtf.forward, static_argnames=(
    "cfg", "compute_dtype", "logits_last_only"))
_jdecode = jax.jit(jtf.decode_step, static_argnames=("cfg", "compute_dtype"))
_jcross = jax.jit(jtf.precompute_cross_kv,
                  static_argnames=("cfg", "compute_dtype"))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(got, want) -> float:
    return float(np.abs(_np(got) - _np(want)).max())


def _port(name, seed=0):
    jcfg, cfg = jreg.smoke_config(name), registry.smoke_config(name)
    jparams = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    params = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
    return jcfg, cfg, jparams, params


# --- whisper (encoder-decoder) ------------------------------------------------

@pytest.fixture(scope="module")
def whisper():
    jcfg, cfg, jparams, params = _port("whisper-medium")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, T))
    frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    jenc = _jencode(jparams, jnp.asarray(frames), cfg=jcfg,
                    compute_dtype=jnp.float32)
    enc = tf.encode(params, torch.tensor(frames), cfg, compute_dtype=F32)
    return jcfg, cfg, jparams, params, toks, jenc, enc


def test_encoder_is_carried_across_and_matches(whisper):
    jcfg, cfg, jparams, params, toks, jenc, enc = whisper
    assert len(params["encoder"]) == cfg.enc_layers
    assert set(params["encoder"][0]) == {"ln1", "ln2", "attn", "mlp"}
    assert set(params["layers"][0]) == {"ln1", "ln2", "attn", "ln_x",
                                        "cross", "mlp"}
    assert enc.shape == (B, cfg.enc_seq, cfg.d_model) and enc.dtype == F32
    assert _err(enc, jenc) < TOL_F32


def test_forward_over_the_encoder_matches(whisper):
    jcfg, cfg, jparams, params, toks, jenc, enc = whisper
    want, jaux = _jforward(jparams, jnp.asarray(toks), cfg=jcfg,
                           enc_kv=jenc, compute_dtype=jnp.float32)
    got, aux = tf.forward(params, torch.tensor(toks), cfg, enc_kv=enc,
                          compute_dtype=F32)
    assert got.shape == (B, T, cfg.vocab_padded)
    assert _err(got, want) < TOL_F32
    assert float(aux.moe_loss) == float(jaux.moe_loss) == 0
    # the cross-attention is on the path: without it the logits change
    plain, _ = tf.forward(params, torch.tensor(toks), cfg, compute_dtype=F32)
    assert float((plain - got).abs().max()) > 1e-2


def test_precompute_cross_kv_matches(whisper):
    jcfg, cfg, jparams, params, toks, jenc, enc = whisper
    jstack, jrest = _jcross(jparams, jenc, cfg=jcfg,
                            compute_dtype=jnp.float32)
    # the reference's (stack per pattern position, remainder) as layers
    period, n_full = cfg.period, cfg.n_layers // cfg.period
    want = [tuple(a[i] for a in jstack[pos]) for i in range(n_full)
            for pos in range(period)] + list(jrest)
    got = tf.precompute_cross_kv(params, enc, cfg, compute_dtype=F32)
    assert len(got) == cfg.n_layers
    for (k, v), (jk, jv) in zip(got, want):
        assert k.shape == (B, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim)
        assert _err(k, jk) < TOL_F32 and _err(v, jv) < TOL_F32


@pytest.mark.parametrize("cross", ["enc_kv", "cross_kv"])
def test_decode_steps_match(whisper, cross):
    """The reference decodes over the encoder's output; the port over it
    and over the cross K/V projected once."""
    jcfg, cfg, jparams, params, toks, jenc, enc = whisper
    jstate = jtf.init_serve(jcfg, B, 24, enc_kv=jenc,
                            cache_dtype=jnp.float32)
    state = tf.init_serve(cfg, B, 24, enc_kv=enc, device="cpu",
                          cache_dtype=F32)
    if cross == "cross_kv":
        state = state._replace(enc_kv=None, cross_kv=tf.precompute_cross_kv(
            params, enc, cfg, compute_dtype=F32))
    for t in range(T):
        jl, jstate = _jdecode(jparams, jnp.asarray(toks[:, t:t + 1]), jstate,
                              cfg=jcfg, compute_dtype=jnp.float32)
        tl, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=F32)
        assert _err(tl, jl) < TOL_F32, t


def test_forward_matches_decode_in_the_port(whisper):
    _, cfg, _, params, toks, _, enc = whisper
    full, _ = tf.forward(params, torch.tensor(toks), cfg, enc_kv=enc,
                         compute_dtype=F32)
    state = tf.init_serve(cfg, B, T, device="cpu", cache_dtype=F32)._replace(
        cross_kv=tf.precompute_cross_kv(params, enc, cfg, compute_dtype=F32))
    for t in range(T):
        lg, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=F32)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < 5e-4, t


def _reference_greedy(jparams, jcfg, prompts, jenc, n_new, max_len):
    """examples/lm_serve.py's enc-dec loop, greedy: the prompt through
    decode steps over the encoder's output, then the argmax token."""
    state = jtf.init_serve(jcfg, prompts.shape[0], max_len, enc_kv=jenc,
                           cache_dtype=jnp.float32)
    logits = None
    for t in range(prompts.shape[1]):
        logits, state = _jdecode(jparams, prompts[:, t:t + 1], state,
                                 cfg=jcfg, compute_dtype=jnp.float32)
    outs = [prompts]
    for _ in range(n_new):
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        outs.append(nxt)
        logits, state = _jdecode(jparams, nxt, state, cfg=jcfg,
                                 compute_dtype=jnp.float32)
    return np.asarray(jnp.concatenate(outs, axis=1))


def test_greedy_generation_matches_the_reference_loop(whisper, monkeypatch):
    """Token for token in float32 (``prefill_then_decode`` fixes bfloat16
    compute and caches, whose roundings flip near-ties of the random smoke
    weights' logits, so its callees are given float32 here)."""
    jcfg, cfg, jparams, params, toks, jenc, enc = whisper
    prompt = torch.tensor(toks[:, :6])
    bf = serve.prefill_then_decode(params, prompt, cfg, max_len=16,
                                   n_decode=8, enc_kv=enc)
    assert torch.equal(bf[:, :6], prompt) and int(bf.max()) < cfg.vocab
    for name, kw in (("init_serve", {"cache_dtype": F32}),
                     ("decode_step", {"compute_dtype": F32}),
                     ("precompute_cross_kv", {"compute_dtype": F32})):
        fn = getattr(tf, name)
        monkeypatch.setattr(tf, name, lambda *a, _f=fn, _k=kw, **k:
                            _f(*a, **k, **_k))
    want = _reference_greedy(jparams, jcfg, jnp.asarray(toks[:, :6]), jenc,
                             8, 16)
    got = serve.prefill_then_decode(params, prompt, cfg, max_len=16,
                                    n_decode=8, enc_kv=enc)
    assert got.shape == (B, 14)
    np.testing.assert_array_equal(_np(got), want)


# --- qwen2-vl (VLM input: patch embeddings and M-RoPE) ------------------------

def vision_positions(batch: int, n_text: int, grid: tuple, n_after: int):
    """Qwen2-VL's (t, h, w) position rows: ``n_text`` text tokens, a
    t x h x w block of patches offset by the text before it, then text
    positions from one past the block's largest; (batch, 3, T)."""
    t, h, w = grid
    text = np.broadcast_to(np.arange(n_text), (3, n_text))
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    vis = np.stack([tt.ravel(), hh.ravel(), ww.ravel()]) + n_text
    start = vis.max() + 1
    after = np.broadcast_to(np.arange(start, start + n_after), (3, n_after))
    pos = np.concatenate([text, vis, after], axis=1)
    return np.broadcast_to(pos, (batch,) + pos.shape).copy()


@pytest.fixture(scope="module")
def vlm():
    jcfg, cfg, jparams, params = _port("qwen2-vl-72b", seed=1)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, T))
    pos = vision_positions(B, 3, (1, 2, 4), T - 11)
    embeds = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32) * 0.02
    return jcfg, cfg, jparams, params, toks, pos, embeds


def test_vision_positions_are_distinct_rows():
    pos = vision_positions(1, 2, (2, 2, 3), 3)
    assert pos.shape == (1, 3, 17)
    assert pos[0, :, :2].tolist() == [[0, 1]] * 3
    assert pos[0, :, 2].tolist() == [2, 2, 2]              # (0, 0, 0) + 2
    assert pos[0, :, 13].tolist() == [3, 3, 4]             # (1, 1, 2) + 2
    assert pos[0, :, 14:].tolist() == [[5, 6, 7]] * 3


def test_inputs_embeds_with_mrope_positions_match(vlm):
    jcfg, cfg, jparams, params, toks, pos, embeds = vlm
    assert cfg.mrope and not (pos[:, 0] == pos[:, 1]).all()
    want, _ = _jforward(jparams, None, cfg=jcfg,
                        inputs_embeds=jnp.asarray(embeds),
                        positions=jnp.asarray(pos), compute_dtype=jnp.float32)
    got, _ = tf.forward(params, None, cfg, inputs_embeds=torch.tensor(embeds),
                        positions=torch.tensor(pos), compute_dtype=F32)
    assert got.shape == (B, T, cfg.vocab_padded)
    assert _err(got, want) < TOL_F32
    # the three rows are read: text-only positions give other logits
    flat, _ = tf.forward(params, None, cfg, inputs_embeds=torch.tensor(embeds),
                         compute_dtype=F32)
    assert float((flat - got).abs().max()) > 1e-3


def test_inputs_embeds_of_the_tokens_equal_the_tokens(vlm):
    _, cfg, _, params, toks, _, _ = vlm
    tt = torch.tensor(toks)
    pos3 = torch.arange(T)[None, None].expand(B, 3, T)
    got, _ = tf.forward(params, None, cfg,
                        inputs_embeds=layers.embed(params["embed"], tt),
                        positions=pos3, compute_dtype=F32)
    want, _ = tf.forward(params, tt, cfg, compute_dtype=F32)
    assert torch.equal(got, want)


def test_vlm_decode_steps_match(vlm):
    jcfg, cfg, jparams, params, toks, _, _ = vlm
    jstate = jtf.init_serve(jcfg, B, T, cache_dtype=jnp.float32)
    state = tf.init_serve(cfg, B, T, device="cpu", cache_dtype=F32)
    for t in range(T):
        jl, jstate = _jdecode(jparams, jnp.asarray(toks[:, t:t + 1]), jstate,
                              cfg=jcfg, compute_dtype=jnp.float32)
        tl, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=F32)
        assert _err(tl, jl) < TOL_F32, t
