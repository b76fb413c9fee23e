"""The port's MoE (``repro_torch.models.moe`` and the MoE layers of
``models.transformer``) on the CPU against the JAX package: ``moe_ffn`` in
both dispatch modes, with and without capacity drops, and the smoke widths
of qwen3-moe-30b-a3b (in both modes), mixtral-8x22b (sliding window + MoE)
and jamba-1.5-large-398b (SSM + attention + MoE). The JAX model's weights
are carried across by ``convert.lm_params_from_arrays``, inputs are made
with numpy from a seed, and both packages compute in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import LayerDesc as JDesc
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import LayerDesc
from repro_torch.models import moe
from repro_torch.models import transformer as tf

B, T = 2, 16
# Both packages run the same float32 graph on the same weights and differ
# in summation order only (test_torch_lm.py).
TOL_F32 = 1e-4
# moe_ffn alone: outputs of order 1 after one SwiGLU, a few float32 ulps;
# the load-balance loss is E * a sum of E products of means.
TOL_Y, TOL_LB = 1e-5, 1e-6

_jmoe_ffn = jax.jit(jmoe.moe_ffn, static_argnames=(
    "top_k", "capacity_factor", "n_groups", "dispatch", "compute_dtype"))
_jforward_x64 = jax.jit(jtf.forward, static_argnames=(
    "cfg", "compute_dtype", "logits_last_only"))
_jdecode_x64 = jax.jit(jtf.decode_step,
                       static_argnames=("cfg", "compute_dtype"))


def _f32_jax(fn):
    """Run a reference model call with 64-bit types off: its gather
    dispatch builds the first-choice one-hot in the default float dtype,
    float64 under the suite's x64 setting, which breaks the period scan's
    float32 carry (the model itself is float32 either way)."""
    def run(*args, **kw):
        with jax.enable_x64(False):
            return fn(*args, **kw)
    return run


_jforward, _jdecode = _f32_jax(_jforward_x64), _f32_jax(_jdecode_x64)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- moe_ffn ------------------------------------------------------------------

E, K, D_MODEL, D_FF = 8, 2, 32, 48


@pytest.fixture(scope="module")
def layer():
    jp = jmoe.init_moe(jax.random.PRNGKey(0), D_MODEL, D_FF, E)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(0).normal(size=(2, 32, D_MODEL)).astype(
        np.float32)
    return jp, tp, x


def _both(layer, dispatch, n_groups, cf):
    jp, tp, x = layer
    want = _jmoe_ffn(jp, jnp.asarray(x), top_k=K, capacity_factor=cf,
                     n_groups=n_groups, dispatch=dispatch,
                     compute_dtype=jnp.float32)
    got = moe.moe_ffn(tp, torch.tensor(x), top_k=K, capacity_factor=cf,
                      n_groups=n_groups, dispatch=dispatch,
                      compute_dtype=torch.float32)
    return got, want


@pytest.mark.parametrize("cf", [0.25, 1.0, 16.0])
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_ffn_matches_the_reference(layer, dispatch, n_groups, cf):
    """The same routing, the same drops and the same output: a token kept
    on one side and dropped on the other would differ by its expert's
    gated output, of order 0.1."""
    jp, tp, x = layer
    (y, aux), (jy, jaux) = _both(layer, dispatch, n_groups, cf)
    # gate_idx: the reference's router (moe.py:65-69) on the same tokens
    tok = x.reshape(n_groups, -1, D_MODEL)
    jprobs = jax.nn.softmax(jnp.asarray(tok) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, K)
    _, _, idx = moe.route(tp, torch.tensor(tok), K)
    np.testing.assert_array_equal(_np(idx), _np(jidx))
    assert float(aux.dropped_fraction) == float(jaux.dropped_fraction)
    if cf < 16:
        assert float(aux.dropped_fraction) > 0
    else:
        assert float(aux.dropped_fraction) == 0
    assert abs(float(aux.load_balance_loss)
               - float(jaux.load_balance_loss)) < TOL_LB
    assert y.shape == x.shape and y.dtype == torch.float32
    assert np.abs(_np(y) - _np(jy)).max() < TOL_Y


@pytest.mark.parametrize("cf", [0.25, 1.0])
def test_dispatch_modes_keep_different_tokens(layer, cf):
    """Under capacity the two modes drop as many pairs but not the same
    ones (k-major against token-major priority), each as the reference."""
    (ye, ae), _ = _both(layer, "einsum", 1, cf)
    (yg, ag), _ = _both(layer, "gather", 1, cf)
    assert float(ae.dropped_fraction) == float(ag.dropped_fraction) > 0
    assert float((ye - yg).abs().max()) > 1e-2
    (ye, _), _ = _both(layer, "einsum", 1, 16.0)
    (yg, _), _ = _both(layer, "gather", 1, 16.0)
    assert float((ye - yg).abs().max()) < TOL_Y


def test_positions_follow_each_modes_priority():
    # token 0 picks experts (0, 1), token 1 picks (1, 0)
    idx = torch.tensor([[[0, 1], [1, 0]]])
    # k-major: both first choices rank before either second choice
    assert moe.positions(idx, 2, "einsum").tolist() == [[[0, 1], [0, 1]]]
    # token-major: token 0's pairs rank before token 1's
    assert moe.positions(idx, 2, "gather").tolist() == [[[0, 0], [1, 1]]]
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn({"router": torch.zeros(4, 2)}, torch.zeros(1, 2, 4),
                    top_k=1, dispatch="sort")


def test_init_moe_scales_follow_the_reference():
    p = moe.init_moe(torch.Generator().manual_seed(0), 64, 96, 4,
                     device="cpu")
    assert p["router"].shape == (64, 4)
    assert p["w_gate"].shape == p["w_in"].shape == (4, 64, 96)
    assert p["w_out"].shape == (4, 96, 64)
    for k, s in (("w_in", 64 ** -0.5), ("w_out", 96 ** -0.5)):
        assert abs(float(p[k].std()) - s) < 0.1 * s


# --- MoE models ---------------------------------------------------------------

def _mixtral_windowed(cfg, desc):
    """mixtral's smoke config with its window cut to 8, so that T = 16
    slides it."""
    return cfg.scaled(layer_pattern=(desc(kind="attn", window=8, moe=True),))


MODELS = {
    "qwen3-moe-einsum": ("qwen3-moe-30b-a3b", {}),
    "qwen3-moe-gather": ("qwen3-moe-30b-a3b", {"moe_dispatch": "gather"}),
    "mixtral-window8": ("mixtral-8x22b", "window"),
    "jamba": ("jamba-1.5-large-398b", {}),
}


def _cfgs(key):
    name, over = MODELS[key]
    jcfg, cfg = jreg.smoke_config(name), registry.smoke_config(name)
    if over == "window":
        return _mixtral_windowed(jcfg, JDesc), _mixtral_windowed(cfg,
                                                                 LayerDesc)
    return jcfg.scaled(**over), cfg.scaled(**over)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, T)).astype(
        np.int32)
    return jcfg, cfg, jparams, params, toks


def test_forward_logits_and_aux_match(model):
    """The default capacity (1.25) drops pairs in these batches: logits
    within TOL_F32 need the same drops layer by layer."""
    jcfg, cfg, jparams, params, toks = model
    want, jaux = _jforward(jparams, jnp.asarray(toks), cfg=jcfg,
                           compute_dtype=jnp.float32)
    got, aux = tf.forward(params, torch.tensor(toks), cfg,
                          compute_dtype=torch.float32)
    assert got.shape == (B, T, cfg.vocab_padded)
    assert np.abs(_np(got) - _np(want)).max() < TOL_F32
    assert abs(float(aux.moe_loss) - float(jaux.moe_loss)) < TOL_LB
    assert abs(float(aux.dropped) - float(jaux.dropped)) < 1e-7
    assert float(aux.dropped) > 0
    last, _ = tf.forward(params, torch.tensor(toks), cfg,
                         compute_dtype=torch.float32, logits_last_only=True)
    assert np.abs(_np(last[:, 0]) - _np(want[:, -1])).max() < TOL_F32


def test_decode_steps_match(model):
    jcfg, cfg, jparams, params, toks = model
    jstate = _f32_jax(jtf.init_serve)(jcfg, B, 24, cache_dtype=jnp.float32)
    state = tf.init_serve(cfg, B, 24, device="cpu", cache_dtype=torch.float32)
    for t in range(T):
        jl, jstate = _jdecode(jparams, jnp.asarray(toks[:, t:t + 1]), jstate,
                              cfg=jcfg, compute_dtype=jnp.float32)
        tl, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=torch.float32)
        assert np.abs(_np(tl) - _np(jl)).max() < TOL_F32, t


def test_forward_matches_decode_in_the_port(model):
    """With a capacity that drops nothing (as tests/test_models.py does:
    a batch and one token drop differently by construction)."""
    _, cfg, _, params, toks = model
    cfg = cfg.scaled(capacity_factor=16.0)
    full, aux = tf.forward(params, torch.tensor(toks), cfg,
                           compute_dtype=torch.float32)
    assert float(aux.dropped) == 0
    state = tf.init_serve(cfg, B, T, device="cpu", cache_dtype=torch.float32)
    for t in range(T):
        lg, state = tf.decode_step(params, torch.tensor(toks[:, t:t + 1]),
                                   state, cfg, compute_dtype=torch.float32)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < 5e-4, t


def test_moe_layers_and_aux_of_a_dense_model():
    cfg = registry.smoke_config("jamba-1.5-large-398b")
    p = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    kinds = [("moe" in lp, "mlp" in lp) for lp in p["layers"]]
    assert kinds == [(d.moe, not d.moe) for d in cfg.plan()]
    assert p["layers"][1]["moe"]["w_in"].shape == (
        cfg.moe_experts, cfg.d_model, cfg.moe_d_ff)
    dense = registry.smoke_config("qwen3-1.7b")
    dp = tf.init_model(dense, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    _, aux = tf.forward(dp, torch.zeros((1, 4), dtype=torch.long), dense,
                        compute_dtype=torch.float32)
    assert float(aux.moe_loss) == 0 and float(aux.dropped) == 0
