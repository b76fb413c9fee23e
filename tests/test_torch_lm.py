"""The port's LM serving slice (``repro_torch.models``, ``launch.serve``,
``configs``) on the CPU against the JAX package, on the smoke widths of
qwen3-1.7b (attention, GQA, qk-norm) and mamba2-130m (SSD): the JAX model's
weights are carried across by ``convert.lm_params_from_arrays``, the tokens
are made with numpy from a seed, and both packages compute in float32.
Every registered config builds, serves and converts at its smoke widths;
the MoE, enc-dec and VLM-input paths are held against the JAX package in
``test_torch_moe.py`` and ``test_torch_encdec.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

MODELS = ["qwen3-1.7b", "mamba2-130m"]
B, T = 2, 16
# Both packages run the same float32 graph on the same weights; they differ
# in summation order only. The logits reach ~1e1 after two layers, so 1e-4
# is a few float32 ulps of the largest logits.
TOL_F32 = 1e-4


def _cfgs(name):
    jcfg = jreg.smoke_config(name)
    cfg = registry.smoke_config(name)
    if jcfg.ssm_state:          # two chunks of 8 in T = 16
        jcfg, cfg = jcfg.scaled(ssm_chunk=8), cfg.scaled(ssm_chunk=8)
    return jcfg, cfg


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, T))
    return jcfg, cfg, jparams, params, toks


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_forward_logits_match(model):
    jcfg, cfg, jparams, params, toks = model
    want, _ = jtf.forward(jparams, jnp.asarray(toks), jcfg,
                          compute_dtype=jnp.float32)
    got, aux = tf.forward(params, torch.tensor(toks), cfg,
                          compute_dtype=torch.float32)
    assert got.shape == (B, T, cfg.vocab_padded)
    assert np.abs(_np(got) - _np(want)).max() < TOL_F32
    assert float(aux.moe_loss) == float(aux.dropped) == 0     # no MoE layer
    last, _ = tf.forward(params, torch.tensor(toks), cfg,
                      compute_dtype=torch.float32, logits_last_only=True)
    want_last, _ = jtf.forward(jparams, jnp.asarray(toks), jcfg,
                               compute_dtype=jnp.float32,
                               logits_last_only=True)
    assert last.shape == (B, 1, cfg.vocab_padded)
    assert np.abs(_np(last) - _np(want_last)).max() < TOL_F32


def test_decode_steps_match(model):
    jcfg, cfg, jparams, params, toks = model
    jstate = jtf.init_serve(jcfg, B, 24, cache_dtype=jnp.float32)
    state = tf.init_serve(cfg, B, 24, device="cpu", cache_dtype=torch.float32)
    for t in range(T):
        jl, jstate = jtf.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]),
                                     jstate, jcfg, compute_dtype=jnp.float32)
        tl, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=torch.float32)
        assert np.abs(_np(tl) - _np(jl)).max() < TOL_F32, t


def _in_f32(monkeypatch, mod, f32):
    """Give a package's ``init_serve``/``decode_step`` float32 caches and
    compute (at run time; no package file is edited)."""
    init_serve, decode_step = mod.init_serve, mod.decode_step
    monkeypatch.setattr(mod, "init_serve", lambda *a, **k: init_serve(
        *a, **k, cache_dtype=f32))
    monkeypatch.setattr(mod, "decode_step", lambda *a, **k: decode_step(
        *a, **k, compute_dtype=f32))


def test_greedy_generation_matches(model, monkeypatch):
    """The same tokens, prompt and all, in float32. Both loops fix bfloat16
    compute and caches, whose two roundings flip near-ties of the random
    smoke weights' logits within a few tokens, so their callees are given
    float32 here."""
    jcfg, cfg, jparams, params, toks = model
    # bfloat16, the default: the prompt is kept and every new token is real
    bf = serve.prefill_then_decode(params, torch.tensor(toks[:, :6]), cfg,
                                   max_len=16, n_decode=8)
    assert torch.equal(bf[:, :6], torch.tensor(toks[:, :6]))
    assert int(bf.max()) < cfg.vocab
    _in_f32(monkeypatch, jtf, jnp.float32)
    _in_f32(monkeypatch, tf, torch.float32)
    want = jserve.prefill_then_decode(jparams, jnp.asarray(toks[:, :6]),
                                      jcfg, max_len=16, n_decode=8)
    got = serve.prefill_then_decode(params, torch.tensor(toks[:, :6]), cfg,
                                    max_len=16, n_decode=8)
    assert got.shape == (B, 14)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_sampling_uses_the_generator(model):
    _, cfg, _, params, toks = model
    prompt = torch.tensor(toks[:, :4])
    runs = [serve.prefill_then_decode(
        params, prompt, cfg, max_len=12, n_decode=6, temperature=1.0,
        generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, :4], prompt)
    assert int(runs[0].max()) < cfg.vocab    # padded columns are never drawn


def test_forward_matches_decode_in_the_port(model):
    _, cfg, _, params, toks = model
    full, _ = tf.forward(params, torch.tensor(toks), cfg,
                         compute_dtype=torch.float32)
    state = tf.init_serve(cfg, B, T, device="cpu", cache_dtype=torch.float32)
    for t in range(T):
        lg, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=torch.float32)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < 5e-4


def test_cache_full_raises(model):
    _, cfg, _, params, toks = model
    with pytest.raises(ValueError, match="exceed max_len"):
        serve.prefill_then_decode(params, torch.tensor(toks[:, :6]), cfg,
                                  max_len=8, n_decode=4)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", jreg.ARCH_NAMES)
def test_registry_is_identical(name, smoke):
    get = "smoke_config" if smoke else "get_config"
    want = getattr(jreg, get)(name)
    got = getattr(registry, get)(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vocab_padded == want.vocab_padded
    assert got.period == want.period
    assert [dataclasses.asdict(d) for d in got.plan()] == \
        [dataclasses.asdict(d) for d in want.plan()]
    assert got.param_counts() == want.param_counts()


def test_registry_names():
    assert registry.ARCH_NAMES == jreg.ARCH_NAMES
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_config("nope")


@pytest.mark.parametrize("name", jreg.ARCH_NAMES)
def test_every_config_builds_serves_and_converts(name):
    """Every registered config, at its smoke widths: ``init_model``,
    ``forward`` (over an encoder's output for enc-dec), ``init_serve`` and
    a decode step run, and ``convert.lm_params_from_arrays`` carries the
    JAX package's tree across with the port's own leaves and shapes."""
    cfg = registry.smoke_config(name)
    p = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    enc = None
    if cfg.enc_dec:
        enc = tf.encode(p, torch.zeros((1, cfg.enc_seq, cfg.d_model)), cfg,
                        compute_dtype=torch.float32)
    logits, aux = tf.forward(p, toks, cfg, enc_kv=enc,
                             compute_dtype=torch.float32)
    assert logits.shape == (1, 8, cfg.vocab_padded)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    assert bool(torch.isfinite(aux.moe_loss)) and 0 <= float(aux.dropped) < 1
    state = tf.init_serve(cfg, 1, 8, enc_kv=enc, device="cpu",
                          cache_dtype=torch.float32)
    lg, _ = tf.decode_step(p, toks[:, :1], state, cfg,
                           compute_dtype=torch.float32)
    assert lg.shape == (1, 1, cfg.vocab_padded)
    tree = jax.tree.map(np.asarray, jtf.init_model(jax.random.PRNGKey(0),
                                                   jreg.smoke_config(name)))
    got = convert.lm_params_from_arrays(tree, cfg, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return None if t is None else tuple(t.shape)

    assert shapes(got) == shapes(p)


def test_init_model_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_model(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_serve(cfg, 1, 8)


def test_init_model_scales_follow_the_reference():
    cfg = registry.smoke_config("qwen3-1.7b")
    p = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert len(p["layers"]) == cfg.n_layers
    wq = p["layers"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    s = cfg.d_model ** -0.5
    assert abs(float(wq.std()) - s) < 0.1 * s
    assert torch.equal(p["layers"][0]["ln1"], torch.zeros(cfg.d_model))
    assert p["embed"]["tok"].shape == (cfg.vocab_padded, cfg.d_model)
    assert "unembed" not in p["embed"]                  # tied


def test_lm_tokens_zipf_stream():
    from repro_torch.data import synthetic
    toks = synthetic.lm_tokens(np.random.default_rng(0), batch=4, seq=255,
                               vocab=1000)
    assert toks.shape == (4, 256) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) <= 999
    # rank-frequency: below the clip at vocab - 1, rank 1 is the most common
    counts = torch.bincount(toks.flatten(), minlength=1000)
    assert int(counts[0]) == 0 and int(counts[:999].argmax()) == 1
    assert counts[1] > counts[2] > counts[3]
    g = synthetic.lm_tokens(torch.Generator().manual_seed(0), batch=2,
                            seq=7, vocab=50)
    assert g.shape == (2, 8) and int(g.max()) < 50


def test_layers_match():
    """The building blocks one by one (models/layers.py), float32."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 6, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    pos = rng.integers(0, 50, size=(2, 6))
    pos3 = rng.integers(0, 50, size=(2, 3, 6))
    tx, jx = torch.tensor(x), jnp.asarray(x)
    pairs = [
        (tl.rms_norm(tx, torch.tensor(w)), jl.rms_norm(jx, jnp.asarray(w))),
        (tl.layer_norm(tx, None, None), jl.layer_norm(jx, None, None)),
        (tl.apply_rope(tx, torch.tensor(pos), 1e4),
         jl.apply_rope(jx, jnp.asarray(pos), 1e4)),
        (tl.apply_mrope(tx, torch.tensor(pos3), 1e6, (4, 2, 2)),
         jl.apply_mrope(jx, jnp.asarray(pos3), 1e6, (4, 2, 2))),
    ]
    mlp_p = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
             (("w_gate", (16, 32)), ("w_in", (16, 32)), ("w_out", (32, 16)))}
    pairs.append((tl.mlp({k: torch.tensor(v) for k, v in mlp_p.items()}, tx,
                         torch.float32),
                  jl.mlp({k: jnp.asarray(v) for k, v in mlp_p.items()}, jx,
                         jnp.float32)))
    tok = rng.normal(size=(40, 16)).astype(np.float32)
    pairs.append((tl.unembed({"tok": torch.tensor(tok)}, tx, torch.float32,
                             n_valid=33),
                  jl.unembed({"tok": jnp.asarray(tok)}, jx, jnp.float32,
                             n_valid=33)))
    for got, want in pairs:
        assert got.shape == tuple(want.shape)
        assert np.abs(_np(got) - _np(want)).max() < 1e-5


def test_sliding_window_ring_cache_matches():
    """A windowed attention stack (window 8 over 16 tokens): the forward's
    chunked sliding-window path and the decode's ring-buffer cache
    (``init_serve(ring_cache=True)``, 8 slots), against the JAX package."""
    from repro.configs.base import LayerDesc as JDesc
    from repro_torch.configs.base import LayerDesc
    jcfg = jreg.smoke_config("qwen3-1.7b").scaled(
        layer_pattern=(JDesc(kind="attn", window=8),))
    cfg = registry.smoke_config("qwen3-1.7b").scaled(
        layer_pattern=(LayerDesc(kind="attn", window=8),))
    jparams = jtf.init_model(jax.random.PRNGKey(3), jcfg)
    params = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, T))
    want, _ = jtf.forward(jparams, jnp.asarray(toks), jcfg,
                          compute_dtype=jnp.float32)
    got, _ = tf.forward(params, torch.tensor(toks), cfg,
                        compute_dtype=torch.float32)
    assert np.abs(_np(got) - _np(want)).max() < TOL_F32
    jstate = jtf.init_serve(jcfg, B, 32, cache_dtype=jnp.float32,
                            ring_cache=True)
    state = tf.init_serve(cfg, B, 32, device="cpu", cache_dtype=torch.float32,
                          ring_cache=True)
    assert state.caches[0].k.shape[2] == 8
    for t in range(T):
        jl, jstate = jtf.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]),
                                     jstate, jcfg, compute_dtype=jnp.float32)
        tl, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=torch.float32)
        assert np.abs(_np(tl) - _np(jl)).max() < TOL_F32, t
        assert float((tl[:, 0] - got[:, t]).abs().max()) < 5e-4, t
