"""The port's attention (``repro_torch.kernels.attention``) on the CPU, where
``ops.attention`` takes its plain version, against the JAX package's Pallas
flash kernel in interpret mode and its jnp oracles, on the reference's
cases (tests/test_kernels.py), decode steps (Tq = 1 with a q_offset) and
bfloat16. Inputs are made with numpy from a seed and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as jops, ref as jref
from repro_torch.kernels.attention import ops, ref

# Both sides compute the softmax and both products in float32 from the same
# inputs, so they differ by summation order only: 1e-5. bfloat16 outputs
# round once (2^-8 relative on values of order 1): the reference's 3e-2.
TOL = {"float32": 1e-5, "bfloat16": 3e-2}

KERNEL_CASES = [(1, 4, 4, 128, 128, 64, None, 0),
                (2, 8, 2, 128, 128, 64, None, 0),       # GQA 4:1
                (1, 4, 4, 256, 256, 32, 128, 0),        # sliding window
                (1, 2, 2, 64, 256, 64, None, 192),      # chunked prefill
                (1, 4, 2, 100, 200, 48, None, 100),     # ragged Tq != Tk
                (1, 1, 1, 64, 64, 128, 32, 0)]
DECODE_CASES = [(2, 4, 2, 1, 64, 32, None, off) for off in (0, 17, 63)] + \
               [(2, 4, 1, 1, 96, 16, 16, off) for off in (5, 40, 95)]


def _qkv(B, Hq, Hkv, Tq, Tk, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _err(got: torch.Tensor, want) -> float:
    w = np.asarray(want.astype(jnp.float32))
    return float(np.abs(got.float().numpy() - w).max())


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,window,off",
                         KERNEL_CASES + DECODE_CASES)
def test_plain_matches_pallas_and_oracle_f32(B, Hq, Hkv, Tq, Tk, D, window,
                                             off):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, Hq, Hkv, Tq, Tk, D, "float32",
                                      Tq * Tk + D)
    ops.reset_counts()
    got = ops.attention(tq, tk, tv, window=window, q_offset=off)
    assert ops.flash_launches == 0          # CPU tensors: the plain path
    assert got.shape == (B, Hq, Tq, D) and got.dtype == torch.float32
    pallas = jops.attention(jq, jk, jv, window=window, q_offset=off,
                            impl="pallas_interpret", block_q=64, block_k=64)
    oracle = jref.attention(jq, jk, jv, window=window, q_offset=off)
    assert _err(got, pallas) < TOL["float32"]
    assert _err(got, oracle) < TOL["float32"]


@pytest.mark.parametrize("Hq,Hkv,T", [(4, 4, 128), (8, 2, 96)])
def test_plain_matches_pallas_bf16(Hq, Hkv, T):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, Hq, Hkv, T, T, 64, "bfloat16", 7)
    got = ops.attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    pallas = jops.attention(jq, jk, jv, impl="pallas_interpret", block_q=64,
                            block_k=64)
    assert _err(got, pallas) < TOL["bfloat16"]


@pytest.mark.parametrize("T,W", [(1024, 128), (2048, 256), (512, 100)])
def test_windowed_chunked_matches_jax(T, W):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 4, 2, T, T, 32, "float32", T + W)
    got = ref.attention_windowed_chunked(tq, tk, tv, window=W)
    assert _err(got, jref.attention_windowed_chunked(jq, jk, jv,
                                                     window=W)) < 1e-5
    # the masked-full plain version is the same function
    full = ref.attention(tq, tk, tv, causal=True, window=W)
    assert float((got - full).abs().max()) < 1e-5


def test_ops_routes_long_windows_to_the_chunked_path():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 2, 1024, 1024, 32, "float32", 0)
    got = ops.attention(tq, tk, tv, causal=True, window=128)
    want = jops.attention(jq, jk, jv, causal=True, window=128, impl="jnp")
    assert _err(got, want) < 1e-5


def test_rows_without_a_key_return_zero():
    """A query whose window ends before the first key: 0, as the flash
    kernels return (the JAX oracle would average v instead)."""
    _, (tq, tk, tv) = _qkv(1, 2, 2, 4, 8, 16, "float32", 3)
    out = ops.attention(tq, tk, tv, causal=True, window=2, q_offset=20)
    assert torch.equal(out, torch.zeros_like(out))


def test_rows_sum_to_one():
    _, (tq, tk, _) = _qkv(1, 2, 2, 128, 128, 64, "float32", 0)
    v = torch.full((1, 2, 128, 64), 3.5)
    out = ops.attention(tq, tk, v)
    assert float((out - 3.5).abs().max()) < 1e-5


# non-causal, as an encoder's self-attention and cross-attention call it:
# against the Pallas kernel in interpret mode where both lengths divide its
# blocks, and against the oracle at whisper-like ragged lengths and Tq = 1
NONCAUSAL_PALLAS = [(1, 4, 2, 64, 128, 64), (2, 4, 4, 128, 128, 32)]
NONCAUSAL_ORACLE = [(2, 4, 2, 1, 150, 16), (1, 4, 4, 45, 150, 16),
                    (1, 2, 1, 7, 1, 16)]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D",
                         NONCAUSAL_PALLAS + NONCAUSAL_ORACLE)
def test_plain_non_causal_matches_the_reference(B, Hq, Hkv, Tq, Tk, D):
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, Hq, Hkv, Tq, Tk, D, "float32",
                                      Tq + Tk + D)
    ops.reset_counts()
    got = ops.attention(tq, tk, tv, causal=False)
    assert ops.flash_launches == ops.flash_noncausal_launches == 0
    oracle = jref.attention(jq, jk, jv, causal=False)
    assert _err(got, oracle) < TOL["float32"]
    if (B, Hq, Hkv, Tq, Tk, D) in NONCAUSAL_PALLAS:
        pallas = jops.attention(jq, jk, jv, causal=False,
                                impl="pallas_interpret", block_q=64,
                                block_k=64)
        assert _err(got, pallas) < TOL["float32"]
