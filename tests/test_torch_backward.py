"""The plain versions the backward kernels are held against on the card
(``repro_torch.kernels.attention.ref.attention_backward`` and
``attention_lse``, ``repro_torch.kernels.ssd.ref.intra_chunk_backward``),
on the CPU, against ``jax.vjp`` of the JAX package's references and
``jax.scipy.special.logsumexp`` of its masked scores. Inputs are made with
numpy from a seed and fed to both packages.

Tolerances: the JAX attention reference computes its softmax and both
products in float32 whatever the input dtype
(``src/repro/kernels/attention/ref.py``), so attention's gradients are
compared in float32, each within 1e-5 of its largest entry (summation order
only). The SSD reference and the log-sum-exp run in float64 on both sides:
1e-10. Rows with no visible key are left out of the attention comparison
(their dO is zero on both sides): there the JAX reference's softmax over
all -1e30 logits returns the mean of v, where the port returns 0 (the
docstring of ``repro_torch.kernels.attention.ref``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ref as jref
from repro.kernels.ssd import ref as jssd_ref
from repro_torch.kernels.attention import ops, ref
from repro_torch.kernels.ssd import ref as ssd_ref

TOL_ATTN, TOL_F64 = 1e-5, 1e-10

# (B, Hq, Hkv, Tq, Tk, D, window, q_offset, causal): causal GQA, non-causal
# with Tq != Tk, a sliding window, a q_offset with Tq != Tk, a window past
# the keys (rows without a visible key), D in {12, 64, 128}
ATTN_CASES = [(2, 4, 2, 16, 16, 64, None, 0, True),
              (1, 4, 2, 24, 24, 128, None, 0, True),
              (1, 2, 2, 12, 20, 12, None, 0, False),
              (2, 4, 1, 10, 30, 128, None, 0, False),
              (1, 4, 2, 24, 24, 64, 5, 0, True),
              (1, 4, 1, 8, 20, 12, None, 12, True),
              (1, 2, 2, 6, 10, 64, 3, 8, True)]


def _mask(Tq, Tk, causal, window, q_offset):
    qpos = np.arange(Tq)[:, None] + q_offset
    kpos = np.arange(Tk)[None, :]
    mask = np.ones((Tq, Tk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _attn_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D),
                      (B, Hq, Tq, D))]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,off,causal", ATTN_CASES)
def test_attention_backward_matches_jax_vjp(B, Hq, Hkv, Tq, Tk, D, window,
                                            off, causal):
    q, k, v, do = _attn_inputs(B, Hq, Hkv, Tq, Tk, D, np.float32)
    keyed = _mask(Tq, Tk, causal, window, off).any(-1)
    do = do * keyed[None, None, :, None]          # rows with a visible key
    kw = dict(causal=causal, window=window, q_offset=off)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = ref.attention_backward(*(torch.tensor(x) for x in (q, k, v, do)),
                                 **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= TOL_ATTN * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,off,causal", ATTN_CASES)
def test_attention_lse_matches_logsumexp(B, Hq, Hkv, Tq, Tk, D, window, off,
                                         causal):
    q, k = _attn_inputs(B, Hq, Hkv, Tq, Tk, D, np.float64)[:2]
    mask = _mask(Tq, Tk, causal, window, off)
    G = Hq // Hkv
    # the reference's masked scores, in float64
    logits = jnp.einsum("bhgqd,bhkd->bhgqk",
                        jnp.asarray(q).reshape(B, Hkv, G, Tq, D),
                        jnp.asarray(k)) * D ** -0.5
    logits = jnp.where(mask[None, None, None], logits, jref.NEG_INF)
    want = np.asarray(jax.scipy.special.logsumexp(logits, axis=-1)
                      ).reshape(B, Hq, Tq)
    got = ref.attention_lse(torch.tensor(q), torch.tensor(k), causal=causal,
                            window=window, q_offset=off)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    keyed = mask.any(-1)
    assert torch.isneginf(got[..., ~keyed]).all()   # as the kernel writes it
    err = float(np.abs(got.numpy()[..., keyed] - want[..., keyed]).max())
    assert err <= TOL_F64, err


def _ssd_inputs(BC, cs, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    ins = (rng.normal(size=(BC, cs, H, P)), -np.abs(rng.normal(
        size=(BC, H, cs))) * 0.1, rng.normal(size=(BC, cs, N)),
        rng.normal(size=(BC, cs, N)))
    outs = (rng.normal(size=(BC, cs, H, P)), rng.normal(size=(BC, H, P, N)),
            rng.normal(size=(BC, H, cs)))
    return ins, outs


# the reference is one (chunk, head) tile: vmapped over heads (xdt's axis 1
# and dA's axis 0 of a chunk; B and C shared), then over chunks, in the
# port's layouts: Y (cs, H, P), S (H, P, N), cum (H, cs) per chunk
_JAX_INTRA = jax.vmap(jax.vmap(jssd_ref.intra_chunk,
                               in_axes=(1, 0, None, None),
                               out_axes=(1, 0, 0)))


@pytest.mark.parametrize("BC,cs,H,P,N", [(2, 16, 3, 8, 8), (3, 40, 2, 5, 7),
                                         (1, 64, 4, 16, 24)])
@pytest.mark.parametrize("given", ["all", "dY only", "none of dY"])
def test_ssd_intra_chunk_backward_matches_jax_vjp(BC, cs, H, P, N, given):
    ins, outs = _ssd_inputs(BC, cs, H, P, N)
    keep = {"all": (1, 1, 1), "dY only": (1, 0, 0),
            "none of dY": (0, 1, 1)}[given]
    _, vjp = jax.vjp(_JAX_INTRA, *(jnp.asarray(a) for a in ins))
    want = vjp(tuple(jnp.asarray(o * k) for o, k in zip(outs, keep)))
    got = ssd_ref.intra_chunk_backward(
        *(torch.tensor(a) for a in ins),
        *(torch.tensor(o) if k else None for o, k in zip(outs, keep)))
    for g, w, name in zip(got, want, ("dxdt", "ddA", "dB", "dC")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        err = float(np.abs(g.double().numpy() - w).max())
        assert err <= TOL_F64 * max(1.0, float(np.abs(w).max())), (name, err)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,route", [
    (lambda: _bf16(2, 4, 64, 64), "sm90"),
    (lambda: _bf16(2, 64, 4, 128).transpose(1, 2), "sm90"),   # (B, T, H, D)
    (lambda: _bf16(2, 4, 64, 256), "pad"),
    (lambda: _bf16(2, 4, 64, 12), "pad"),
    (lambda: _bf16(2, 4, 64, 132)[..., 4:], "pad"),           # misaligned
    (lambda: torch.zeros((2, 4, 64, 64)), "f32")])
def test_flash_backward_route_rule(make, route):
    """The rule ``attention_backward`` routes CUDA inputs by, from dtype, D,
    strides and alignment alone (it reads no device memory)."""
    t = make()
    assert ops.bwd_route(t, t, t, t) == route
