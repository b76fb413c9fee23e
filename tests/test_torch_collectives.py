"""The port's collective building blocks on the stacked machine axis (one
process, a ``VmapRunner``'s axis) against the JAX package's under
``jax.vmap(axis_name=...)``, on the same arrays, in float64 on the CPU:
``ring_all_reduce`` (the reference's ``tests/test_collectives.py`` cases:
it matches psum, compressed it stays close, any shape),
``overlapped_psum_pair``, ``compressed_psum`` and ``compress_grads`` with
error feedback (the reference's ``tests/test_substrate.py`` cases).

Port and reference do the same float64 operations in the same order (the
int8 quantization included), so they are held within 1e-12; the
reference's own bounds against the exact sum are checked too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcompression
from repro.parallel.collectives import overlapped_psum_pair as j_pair, \
    ring_all_reduce as j_ring
from repro_torch.optim import compression
from repro_torch.parallel.collectives import overlapped_psum_pair, \
    ring_all_reduce
from repro_torch.parallel.runner import VmapRunner

TOL = 1e-12


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got.numpy(), np.float64)
                        - np.asarray(want, np.float64)).max())


def _ring(xs: np.ndarray, compressed=False):
    M = xs.shape[0]
    got = ring_all_reduce(torch.tensor(xs), VmapRunner(M=M).axis,
                          axis_size=M, compressed=compressed)
    want = jax.vmap(lambda x: j_ring(x, "m", axis_size=M,
                                     compressed=compressed),
                    axis_name="m")(jnp.asarray(xs))
    return got, np.asarray(want)


def test_ring_matches_psum():
    xs = np.random.default_rng(0).normal(size=(8, 37, 5))
    got, want = _ring(xs)
    assert got.shape == (8, 37, 5)
    assert _err(got, want) < TOL
    for m in range(8):
        assert _err(got[m], xs.sum(0)) < 1e-10


def test_ring_compressed_close():
    xs = np.random.default_rng(1).normal(size=(4, 64)) * 0.1
    got, want = _ring(xs, compressed=True)
    assert _err(got, want) < TOL
    exact = xs.sum(0)
    assert _err(got[0], exact) / (np.abs(exact).max() + 1e-9) < 0.1


@pytest.mark.parametrize("m,n,seed", [(2, 2, 0), (3, 17, 1), (4, 50, 2),
                                      (8, 5, 3), (8, 33, 4), (3, 2, 5)])
def test_ring_any_shape(m, n, seed):
    xs = np.random.default_rng(seed).normal(size=(m, n))
    got, want = _ring(xs)
    assert _err(got, want) < TOL
    assert _err(got[0], xs.sum(0)) < 1e-10


def test_ring_of_one_machine_is_the_input():
    x = torch.randn(1, 7, dtype=torch.float64)
    assert ring_all_reduce(x, VmapRunner(M=1).axis, axis_size=1) is x


def test_overlapped_psum_pair_matches_reference():
    rng = np.random.default_rng(2)
    big, small = rng.normal(size=(4, 64, 8)), rng.normal(size=(4, 3))
    got = overlapped_psum_pair(torch.tensor(big), torch.tensor(small),
                               VmapRunner(M=4).axis)
    want = jax.vmap(lambda b, s: j_pair(b, s, "m"), axis_name="m")(
        jnp.asarray(big), jnp.asarray(small))
    assert _err(got[0], want[0][0]) < TOL and _err(got[1], want[1][0]) < TOL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compressed_psum_matches_reference(dtype):
    xs = np.random.default_rng(3).normal(size=(8, 256)).astype(dtype)
    got = compression.compressed_psum(torch.tensor(xs),
                                      VmapRunner(M=8).axis)
    want = jax.vmap(lambda x: jcompression.compressed_psum(x, "m"),
                    axis_name="m")(jnp.asarray(xs))
    assert got.shape == (256,)
    assert _err(got, want[0]) <= (TOL if dtype == np.float64 else 1e-6)
    exact = xs.astype(np.float64).sum(0)
    assert _err(got, exact) / (np.abs(exact).max() + 1e-9) < 0.05


def test_compress_grads_error_feedback_matches_reference():
    """50 steps of error feedback: the same compressed gradients and error
    state as the reference, and the telescoping bound (the summed
    difference within a few quantization steps)."""
    g = np.random.default_rng(4).normal(size=(1000,)) * 0.01
    ef = compression.init_ef({"g": torch.tensor(g)})
    jef = jcompression.init_ef({"g": jnp.asarray(g)})
    tot_true, tot_comp = np.zeros_like(g), np.zeros_like(g)
    for i in range(50):
        gi = g * (1 + 0.1 * i)
        ci, ef = compression.compress_grads({"g": torch.tensor(gi)}, ef)
        jci, jef = jcompression.compress_grads({"g": jnp.asarray(gi)}, jef)
        assert _err(ci["g"], jci["g"]) < TOL
        assert _err(ef.error["g"], jef.error["g"]) < TOL
        tot_true += gi
        tot_comp += ci["g"].numpy()
    err = np.abs(tot_true - tot_comp).max()
    assert err < 4 * np.abs(tot_true).max() / 127.0


def test_compress_grads_keeps_each_leaf_dtype_and_tree():
    grads = {"a": torch.ones(3, dtype=torch.float32),
             "b": [torch.full((2,), 0.5, dtype=torch.float64)]}
    out, ef = compression.compress_grads(grads, compression.init_ef(grads))
    assert out["a"].dtype == torch.float32 and out["b"][0].dtype == \
        torch.float64
    assert isinstance(out["b"], list) and set(ef.error) == {"a", "b"}
