"""The port's LM training slice (``transformer.lm_loss``, remat,
``launch.train``) on the CPU against the JAX package, at smoke widths.

The JAX model's weights (and a whole ``TrainState``) are carried across by
``convert``; tokens, labels, frames and patch embeddings are made with
numpy from a seed; both packages compute in float32. The reference's calls
run under one ``jax.jit`` each, with 64-bit types off (its gather-mode MoE
needs that, as ``test_torch_moe.py`` explains; every model is float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.optim.adam import Adam as JAdam
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from repro_torch.optim.adam import Adam, tree_leaves

B, T = 2, 16
F32 = torch.float32
# Both packages run the same float32 graph on the same weights and differ
# in summation order only: the loss to a few float32 ulps, each gradient
# leaf to 1e-4 of its own largest entry.
TOL_LOSS, TOL_GRAD = 1e-5, 1e-4
# One Adam step: m / sqrt(v) turns a rounding difference in a near-zero
# gradient into up to +-lr on that element, so parameters are compared by
# the fraction of elements that differ by more than 2e-5 (the reference's
# own rule, tests/test_launch.py:114-119).
MISMATCH_ABS, MISMATCH_FRAC = 2e-5, 0.01

# (name, config overrides, batch extras): six families of configs, the
# MoE in both dispatch modes
CASES = [("qwen3-1.7b", {}, ()), ("mamba2-130m", {}, ()),
         ("olmo-1b", {}, ()), ("qwen3-moe-30b-a3b", {}, ()),
         ("qwen3-moe-30b-a3b", {"moe_dispatch": "gather"}, ()),
         ("whisper-medium", {}, ("frames",)),
         ("qwen2-vl-72b", {}, ("inputs_embeds",))]


def _no_x64(fn):
    def run(*args, **kw):
        with jax.enable_x64(False):
            return fn(*args, **kw)
    return run


def _jloss(params, batch, cfg, remat):
    enc = None
    if "frames" in batch:
        enc = jtf.encode(params, batch["frames"], cfg,
                         compute_dtype=jnp.float32)
    return jtf.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                       enc_kv=enc, inputs_embeds=batch.get("inputs_embeds"),
                       compute_dtype=jnp.float32, remat=remat)


_jvg = _no_x64(jax.jit(jax.value_and_grad(_jloss, has_aux=True),
                       static_argnames=("cfg", "remat")))


def _ploss(params, batch, cfg, remat=False):
    enc = None
    if "frames" in batch:
        enc = tf.encode(params, batch["frames"], cfg, compute_dtype=F32)
    return tf.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                      enc_kv=enc, inputs_embeds=batch.get("inputs_embeds"),
                      compute_dtype=F32, remat=remat)


def _pvg(params, batch, cfg, remat=False):
    """(loss, aux), grads of the port's loss, tree like ``params``."""
    return train.value_and_grad(lambda p, b: _ploss(p, b, cfg, remat),
                                params, batch)


def _cfgs(name, overrides):
    jcfg = jreg.smoke_config(name).scaled(**overrides)
    cfg = registry.smoke_config(name).scaled(**overrides)
    if jcfg.moe_experts:      # every pair fits: nothing drops in either
        cf = jcfg.moe_experts / jcfg.moe_top_k
        jcfg, cfg = jcfg.scaled(capacity_factor=cf), \
            cfg.scaled(capacity_factor=cf)
    return jcfg, cfg


def _batch(cfg, extras, batch=B, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, T + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if "frames" in extras:
        out["frames"] = rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)
                                   ).astype(np.float32)
    if "inputs_embeds" in extras:
        out["inputs_embeds"] = rng.normal(size=(batch, T, cfg.d_model)
                                          ).astype(np.float32)
    return ({k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i"
                            else v) for k, v in out.items()},
            {k: torch.tensor(v) for k, v in out.items()})


def _port_grads(jgrads, cfg):
    return convert.lm_params_from_arrays(jax.tree.map(np.asarray, jgrads),
                                         cfg, device="cpu")


@pytest.mark.parametrize("name,overrides,extras", CASES,
                         ids=[f"{c[0]}-{c[1].get('moe_dispatch', '')}"
                              for c in CASES])
def test_loss_and_gradients_match(name, overrides, extras):
    jcfg, cfg = _cfgs(name, overrides)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
    jb, tb = _batch(cfg, extras)
    (jl, jaux), jg = _jvg(jparams, jb, cfg=jcfg, remat=False)
    (loss, aux), grads = _pvg(params, tb, cfg)
    assert abs(float(loss) - float(jl)) <= TOL_LOSS * abs(float(jl))
    assert abs(float(aux.moe_loss) - float(jaux.moe_loss)) <= 1e-5
    assert float(aux.dropped) == float(jaux.dropped) == 0.0
    want = tree_leaves(_port_grads(jg, cfg))
    got = tree_leaves(grads)
    assert len(got) == len(want)
    nonzero = 0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= TOL_GRAD * scale + 1e-12
        nonzero += scale > 0
    # the loss reaches every leaf (the encoder's through the frames) but
    # the token table when patch embeddings replace the tokens
    assert nonzero == len(want) - ("inputs_embeds" in extras)


_jvg_groups = _no_x64(jax.jit(jax.value_and_grad(
    lambda p, b, cfg, groups: jtf.lm_loss(
        p, b["tokens"], b["labels"], cfg, compute_dtype=jnp.float32,
        moe_groups=groups), has_aux=True),
    static_argnames=("cfg", "groups")))


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_groups_match(dispatch):
    """``moe_groups=2``: each half of the tokens routed on its own, at the
    config's own capacity (pairs may drop in a group), against the
    reference's ``lm_loss(moe_groups=2)``: the loss, the MoE loss, the
    dropped share and every gradient leaf."""
    jcfg = jreg.smoke_config("qwen3-moe-30b-a3b").scaled(
        moe_dispatch=dispatch)
    cfg = registry.smoke_config("qwen3-moe-30b-a3b").scaled(
        moe_dispatch=dispatch)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
    jb, tb = _batch(cfg, ())
    (jl, jaux), jg = _jvg_groups(jparams, jb, cfg=jcfg, groups=2)
    (loss, aux), grads = train.value_and_grad(
        lambda p, b: tf.lm_loss(p, b["tokens"], b["labels"], cfg,
                                compute_dtype=F32, moe_groups=2),
        params, tb)
    assert abs(float(loss) - float(jl)) <= TOL_LOSS * abs(float(jl))
    assert abs(float(aux.moe_loss) - float(jaux.moe_loss)) <= 1e-5
    assert abs(float(aux.dropped) - float(jaux.dropped)) <= 1e-6
    assert float(aux.dropped) > 0          # the groups' capacity binds
    for g, w in zip(tree_leaves(grads), tree_leaves(_port_grads(jg, cfg))):
        assert float((g - w).abs().max()) <= \
            TOL_GRAD * float(w.abs().max()) + 1e-12


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m"])
def test_remat_on_and_off_are_bitwise_equal(name):
    _, cfg = _cfgs(name, {})
    params = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    _, tb = _batch(cfg, ())
    (l0, _), g0 = _pvg(params, tb, cfg, remat=False)
    (l1, _), g1 = _pvg(params, tb, cfg, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        tf.lm_loss(params, tb["tokens"], tb["labels"], cfg, remat=True,
                   remat_policy="dots_saveable")


# --- the train step ------------------------------------------------------------

_jstep_cache = {}


def _jstep(cfg, opt, **kw):
    key = (cfg, opt, tuple(sorted(kw.items())))
    if key not in _jstep_cache:
        step, _ = jtrain.make_train_step(cfg, None, opt, **kw)
        _jstep_cache[key] = _no_x64(jax.jit(step))
    return _jstep_cache[key]


def _mismatch(a, b) -> float:
    return float(((a - b).abs() > MISMATCH_ABS).float().mean())


def _assert_states_close(state, jstate, cfg):
    want = convert.train_state_from_arrays(jax.tree.map(np.asarray, jstate),
                                           cfg, device="cpu")
    assert int(state.step) == int(want.step)
    assert int(state.opt.step) == int(want.opt.step)
    for a, b in zip(tree_leaves(state.params), tree_leaves(want.params)):
        assert _mismatch(a, b) < MISMATCH_FRAC


@pytest.fixture(scope="module")
def f32_steps():
    """Both packages' train steps compute in float32 (the bfloat16 default's
    roundings the two packages place apart): the port's by its
    ``compute_dtype``, the reference's, which has none, by giving its loss
    and encoder float32 compute at run time (no package file is
    edited)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("lm_loss", "encode"):
            orig = getattr(jtf, name)
            mp.setattr(jtf, name, lambda *a, _o=orig, **k:
                       _o(*a, **{"compute_dtype": jnp.float32, **k}))
        yield


@pytest.fixture(scope="module")
def dense(f32_steps):
    """qwen3-1.7b's smoke config, the reference's initial TrainState (with
    error feedback) and a batch of 4."""
    jcfg, cfg = _cfgs("qwen3-1.7b", {})
    opt, jopt = Adam(lr=1e-3), JAdam(lr=1e-3)
    jstate = _no_x64(jtrain.init_state)(jax.random.PRNGKey(0), jcfg, jopt,
                                        compress=True)
    jb, tb = _batch(cfg, (), batch=4, seed=3)
    return jcfg, cfg, opt, jopt, jstate, jb, tb


def _port_state(jstate, cfg):
    return convert.train_state_from_arrays(jax.tree.map(np.asarray, jstate),
                                           cfg, device="cpu")


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(dense, compress):
    """One step, then a second (the error feedback carried), against the
    reference's: metrics within tolerance, parameters by mismatch
    fraction."""
    jcfg, cfg, opt, jopt, jstate, jb, tb = dense
    state = _port_state(jstate, cfg)
    step, on_mesh = train.make_train_step(cfg, None, opt, compress=compress,
                                          compute_dtype=F32)
    jstep = _jstep(jcfg, jopt, compress=compress)
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert abs(float(m.loss) - float(jm.loss)) <= \
            TOL_LOSS * abs(float(jm.loss))
        assert abs(float(m.grad_norm) - float(jm.grad_norm)) <= \
            1e-4 * float(jm.grad_norm)
        assert float(m.moe_loss) == float(jm.moe_loss) == 0.0
    _assert_states_close(state, jstate, cfg)
    if compress:
        # the error feedback g + e - q(g + e) is a residual below half a
        # quantum (max|g + e| / 254) that keeps the gradients' absolute
        # rounding differences (~1e-4 of max|g|, 1-3% of the residual's
        # size); an element whose quantization rounded to another level
        # differs by a whole quantum, 2x the largest residual
        want = _port_state(jstate, cfg).ef.error
        for a, b in zip(tree_leaves(state.ef.error), tree_leaves(want)):
            far = (a - b).abs() > 0.1 * float(b.abs().max())
            assert float(far.float().mean()) < MISMATCH_FRAC
    with pytest.raises(ValueError, match="on_mesh needs a mesh"):
        on_mesh(state)


def test_microbatches_match_one_batch(dense):
    """microbatches=2 against 1 on the same batch of 4 (the reference's
    own rule, tests/test_launch.py:93-119)."""
    jcfg, cfg, opt, jopt, jstate, jb, tb = dense
    s1 = _port_state(jstate, cfg)
    s2 = _port_state(jstate, cfg)
    f1, _ = train.make_train_step(cfg, None, opt, microbatches=1,
                                  compute_dtype=F32)
    f2, _ = train.make_train_step(cfg, None, opt, microbatches=2,
                                  compute_dtype=F32)
    s1, m1 = f1(s1, tb)
    s2, m2 = f2(s2, tb)
    assert abs(float(m1.loss) - float(m2.loss)) <= 1e-5 * float(m1.loss)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert _mismatch(a, b) < MISMATCH_FRAC
    # and the reference's microbatched step
    js, jm = _jstep(jcfg, jopt, microbatches=2)(jstate, jb)
    assert abs(float(m2.loss) - float(jm.loss)) <= 1e-5 * float(jm.loss)
    _assert_states_close(s2, js, cfg)


def test_train_step_on_enc_dec_frames(f32_steps):
    """whisper's batch with "frames": the step encodes them inside the
    loss, as the reference's does, and the encoder's weights move."""
    jcfg, cfg = _cfgs("whisper-medium", {})
    opt, jopt = Adam(lr=1e-3), JAdam(lr=1e-3)
    jstate = _no_x64(jtrain.init_state)(jax.random.PRNGKey(0), jcfg, jopt)
    state = _port_state(jstate, cfg)
    jb, tb = _batch(cfg, ("frames",))
    jstate, jm = _jstep(jcfg, jopt)(jstate, jb)
    new, m = train.make_train_step(cfg, None, opt,
                                   compute_dtype=F32)[0](state, tb)
    assert abs(float(m.loss) - float(jm.loss)) <= TOL_LOSS * float(jm.loss)
    _assert_states_close(new, jstate, cfg)
    enc0 = state.params["encoder"][0]["attn"]["wq"]
    assert not torch.equal(new.params["encoder"][0]["attn"]["wq"], enc0)


def test_init_state_and_state_specs():
    _, cfg = _cfgs("qwen3-1.7b", {})
    opt = Adam(lr=1e-3)
    state = train.init_state(cfg, opt, generator=torch.Generator(),
                             device="cpu", compress=True)
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    assert all(float(t.abs().max()) == 0 for t in tree_leaves(state.opt.mu))
    assert len(tree_leaves(state.ef.error)) == len(tree_leaves(state.params))
    specs = train.state_specs(state, {"data": 4, "model": 2})
    assert specs.step == () and specs.opt.step == ()
    assert specs.opt.mu is specs.params and specs.ef.error is specs.params
    # the smoke model is far below 4 GB: every parameter replicated
    leaf = specs.params["layers"][0]["attn"]["wq"]
    assert leaf == (None, None)
