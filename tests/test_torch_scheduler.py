"""The port's continuous batcher (``launch.scheduler``) against the JAX
package's, at smoke widths of qwen3-1.7b (attention) and mamba2-130m (SSD):
the same queue of requests (more than the slots, mixed prompt and output
lengths, one long enough to fill its cache, an EOS id taken from the
reference's own first run) gives the same tokens for each request and the
same finish order. The JAX model's weights are carried across by
``convert.lm_params_from_arrays``.

Both batchers' callees are given float32 caches and compute at run time
(``_in_f32``, as ``test_torch_lm.py`` does): bfloat16's two roundings flip
near-ties of the random smoke weights' logits within a few tokens. Sampling
(``greedy=False``) cannot match JAX's ``random.categorical`` bit for bit,
so it is held within the port: the same seed, the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import scheduler as jsched
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import scheduler
from repro_torch.models import transformer as tf

SLOTS, MAX_LEN = 3, 24
# (prompt length, max_new): seven requests for three slots; the last one's
# prompt and output reach the cache's end (fed + out >= MAX_LEN - 1)
SHAPES = [(5, 6), (3, 9), (8, 4), (2, 7), (6, 5), (4, 8), (12, 20)]


def _in_f32(monkeypatch, mod, f32):
    """Give a package's ``init_serve``/``decode_step`` float32 caches and
    compute (at run time; no package file is edited)."""
    init_serve, decode_step = mod.init_serve, mod.decode_step
    monkeypatch.setattr(mod, "init_serve", lambda *a, **k: init_serve(
        *a, **k, cache_dtype=f32))
    monkeypatch.setattr(mod, "decode_step", lambda *a, **k: decode_step(
        *a, **k, compute_dtype=f32))


@pytest.fixture(scope="module", params=["qwen3-1.7b", "mamba2-130m"])
def model(request):
    jcfg = jreg.smoke_config(request.param)
    cfg = registry.smoke_config(request.param)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n, _ in SHAPES]
    return jcfg, cfg, jparams, params, prompts


def _run(mod, params, cfg, prompts, **kw):
    b = mod.ContinuousBatcher(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                              **kw)
    for rid, (prompt, (_, max_new)) in enumerate(zip(prompts, SHAPES)):
        b.submit(mod.Request(rid, list(prompt), max_new=max_new))
    return [(r.rid, list(r.out)) for r in b.run()]


def test_batcher_matches_the_reference(model, monkeypatch):
    jcfg, cfg, jparams, params, prompts = model
    _in_f32(monkeypatch, jtf, jnp.float32)
    _in_f32(monkeypatch, tf, torch.float32)
    first = _run(jsched, jparams, jcfg, prompts)
    assert _run(scheduler, params, cfg, prompts, device="cpu") == first
    # an EOS id that request 1 emits midway, from the reference's run
    eos = first[[rid for rid, _ in first].index(1)][1][3]
    want = _run(jsched, jparams, jcfg, prompts, eos_id=eos)
    got = _run(scheduler, params, cfg, prompts, eos_id=eos, device="cpu")
    assert got == want
    ended = [out for _, out in got if out[-1] == eos]
    assert any(len(out) < SHAPES[rid][1] for rid, out in got
               if out[-1] == eos) and ended
    # the finish order is not the submit order, and the long request
    # stopped at the cache's end
    assert [rid for rid, _ in got] != sorted(rid for rid, _ in got)
    long_out = dict(got)[len(SHAPES) - 1]
    assert SHAPES[-1][0] + len(long_out) == MAX_LEN - 1


def test_sampling_is_seeded(model):
    _, cfg, _, params, prompts = model
    runs = [_run(scheduler, params, cfg, prompts, greedy=False, seed=s,
                 device="cpu") for s in (7, 7, 8)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    for rid, out in runs[0]:
        assert len(out) <= SHAPES[rid][1]
        assert all(0 <= t < cfg.vocab for t in out)   # no padding column


def test_the_card_is_the_default(model, monkeypatch):
    _, cfg, _, params, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scheduler.ContinuousBatcher(params, cfg)
