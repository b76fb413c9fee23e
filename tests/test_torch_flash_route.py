"""Which flash kernel a CUDA call takes (``ops.route``), decided from the
inputs alone, and the zero-padded path that brings bfloat16 inputs TMA
cannot address to the Hopper kernel. Both run here on the CPU: ``route``
reads only dtype, shape, strides and alignment, and the pad path is checked
on the plain version in float64, against the port's unpadded plain version
and the JAX package's oracle. Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ref as jref
from repro_torch.kernels.attention import ops, ref

BF16 = torch.bfloat16


def _bthd_view(B, T, H, D, dtype=BF16):
    """(B, H, T, D) view of a (B, T, H, D) buffer, as the projections leave
    q, k and v."""
    return torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)


def _decode_query(B, Hq, D):
    """A decode step's q: (B, 1, Hq * D) projected, seen as (B, Hq, 1, D)."""
    return torch.zeros((B, 1, Hq * D), dtype=BF16).reshape(
        B, 1, Hq, D).transpose(1, 2)


def _misaligned(B, H, T, D):
    """A slice whose base is 8 bytes past a 16-byte boundary."""
    return torch.zeros((B, H, T, D + 8), dtype=BF16)[..., 4:D + 4]


ROUTE_CASES = {
    "qwen3 prefill (B, T, H, D) views": (
        lambda: (_bthd_view(2, 16, 16, 128), _bthd_view(2, 16, 8, 128),
                 _bthd_view(2, 16, 8, 128)), "sm90"),
    "decode query against a (B, Hkv, W, D) cache": (
        lambda: (_decode_query(2, 16, 128),
                 torch.zeros((2, 8, 64, 128), dtype=BF16),
                 torch.zeros((2, 8, 64, 128), dtype=BF16)), "sm90"),
    "D = 100": (
        lambda: tuple(torch.zeros((1, 2, 8, 100), dtype=BF16)
                      for _ in range(3)), "pad"),
    "misaligned slice": (
        lambda: (_misaligned(1, 2, 8, 64),) + tuple(
            torch.zeros((1, 2, 8, 64), dtype=BF16) for _ in range(2)),
        "pad"),
    "row stride not a multiple of 8": (
        lambda: (torch.zeros((1, 2, 8, 68), dtype=BF16)[..., :64],) * 3,
        "pad"),
    "float32": (
        lambda: tuple(torch.zeros((1, 2, 8, 64)) for _ in range(3)), "f32"),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_route(name):
    make, want = ROUTE_CASES[name]
    q, k, v = make()
    assert ops.route(q, k, v) == want


# (Tq, Tk, causal, window, q_offset)
PAD_CASES = [(24, 24, True, None, 0),
             (24, 24, False, None, 0),
             (24, 24, True, 8, 0),
             (8, 40, True, None, 32),          # chunked prefill
             (1, 40, True, 16, 39),            # decode with a window
             (6, 30, True, 4, 28)]             # the last row sees no key: 0


@pytest.mark.parametrize("Tq,Tk,causal,window,off", PAD_CASES)
def test_pad_path_is_the_unpadded_function(Tq, Tk, causal, window, off):
    """D = 100 zero-padded to 104, with the scale of D = 100, then sliced
    back: the same function as the unpadded one (float64, 1e-12)."""
    D, width = 100, 104
    rng = np.random.default_rng(Tq * Tk + off)
    arrs = [rng.normal(size=s) for s in ((2, 4, Tq, D), (2, 2, Tk, D),
                                         (2, 2, Tk, D))]
    q, k, v = (torch.tensor(a) for a in arrs)
    padded = [ops.pad_head_dim(t, width) for t in (q, k, v)]
    assert all(p.shape[-1] == width and p.is_contiguous() for p in padded)
    assert ops.route(*(p.to(BF16) for p in padded)) == "sm90"
    got = ref.attention(*padded, causal=causal, window=window,
                        scale=D ** -0.5, q_offset=off)
    assert torch.equal(got[..., D:], torch.zeros_like(got[..., D:]))
    want = ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=off)
    assert float((got[..., :D] - want).abs().max()) < 1e-12
    # rows with a visible key: the JAX oracle's function too, which that
    # oracle computes in float32 (1e-5, as in test_torch_attention.py)
    oracle = np.asarray(jref.attention(*(jnp.asarray(a) for a in arrs),
                                       causal=causal, window=window,
                                       q_offset=off))
    seen = want.abs().amax(-1) > 0
    assert seen.any()
    assert np.abs(got[..., :D].numpy() - oracle)[seen.numpy()].max() < 1e-5


def test_qwen3_attention_calls_route_to_the_hopper_kernel(monkeypatch):
    """Every attention call of the qwen3 smoke model's bf16 prefill and
    decode steps has inputs the Hopper kernel reads in place."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import transformer as tf
    cfg = smoke_config("qwen3-1.7b")
    params = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    routes = []
    plain = ops.attention

    def spy(q, k, v, **kw):
        routes.append(ops.route(q, k, v))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", spy)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (2, 16)))
    tf.forward(params, toks, cfg, compute_dtype=BF16)
    state = tf.init_serve(cfg, 2, 8, device="cpu")
    for t in range(3):
        _, state = tf.decode_step(params, toks[:, t:t + 1], state, cfg,
                                  compute_dtype=BF16)
    assert len(routes) == 4 * cfg.n_layers
    assert set(routes) == {"sm90"}
