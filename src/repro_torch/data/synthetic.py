"""Synthetic datasets mirroring the paper's two domains — port of the GP part
of ``repro.data.synthetic``, and its LM token stream.

The real AIMPEAK/SARCOS data are not vendored; these generators reproduce
their statistical shape (dimensions, scale, noise levels quoted in Sec. 6).
Large-n GP draws use random Fourier features. Draws come from a seeded
``torch.Generator`` on the target device, so they differ from the JAX
package's ``jax.random`` draws for the same seed; tests that compare the two
packages make their inputs with numpy instead.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import device as _device


class Dataset(NamedTuple):
    X: torch.Tensor
    y: torch.Tensor
    X_test: torch.Tensor
    y_test: torch.Tensor
    mean_y: torch.Tensor
    std_y: torch.Tensor


def rff_function(gen: torch.Generator, d: int, *, n_features: int = 512,
                 lengthscale=1.0, signal: float = 1.0):
    """Random smooth function ~ GP(0, SE kernel) via random Fourier
    features, drawn on ``gen``'s device."""
    dev = gen.device
    ls = torch.as_tensor(lengthscale, dtype=torch.float32).to(dev).expand(d)
    W = torch.randn((n_features, d), generator=gen, device=dev) / ls[None, :]
    b = torch.rand((n_features,), generator=gen, device=dev) * (2 * math.pi)
    a = torch.randn((n_features,), generator=gen, device=dev) * signal

    def f(X):
        phi = torch.cos(X @ W.T + b) * math.sqrt(2.0 / n_features)
        return phi @ a

    return f


def _make(n, n_test, d, *, lengthscale, noise, out_mean, out_std, seed,
          device):
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = rff_function(gen, d, lengthscale=lengthscale)
    X = torch.rand((n, d), generator=gen, device=dev) * 4.0 - 2.0
    Xt = torch.rand((n_test, d), generator=gen, device=dev) * 4.0 - 2.0
    fy = f(torch.cat([X, Xt]))
    fy = (fy - fy.mean()) / (fy.std(correction=0) + 1e-9)
    eps = noise * torch.randn((n + n_test,), generator=gen, device=dev)
    y_all = out_mean + out_std * (fy + eps)
    return Dataset(X, y_all[:n], Xt, y_all[n:],
                   torch.tensor(out_mean, device=dev),
                   torch.tensor(out_std, device=dev))


def aimpeak_like(n: int = 8000, n_test: int = 800, *, seed: int = 0,
                 device=None) -> Dataset:
    """Traffic-speed-like: 5-d inputs (length, lanes, limit, direction,
    time), mean 49.5 km/h, sd 21.7 (paper Sec. 6). On the CUDA card unless
    ``device`` names another."""
    return _make(n, n_test, 5, lengthscale=1.2, noise=0.3, out_mean=49.5,
                 out_std=21.7, seed=seed, device=device)


def sarcos_like(n: int = 8000, n_test: int = 800, *, seed: int = 0,
                device=None) -> Dataset:
    """Robot-arm inverse-dynamics-like: 21-d inputs (7 pos + 7 vel + 7 acc),
    torque mean 13.7, sd 20.5 (paper Sec. 6)."""
    # lengthscale ~ sqrt(d) keeps typical pairwise correlations O(1)
    return _make(n, n_test, 21, lengthscale=4.5, noise=0.25, out_mean=13.7,
                 out_std=20.5, seed=seed, device=device)


def standardize(ds: Dataset) -> Dataset:
    """Center/scale outputs (the GP core assumes zero prior mean)."""
    return Dataset(ds.X, (ds.y - ds.mean_y) / ds.std_y, ds.X_test,
                   (ds.y_test - ds.mean_y) / ds.std_y, ds.mean_y, ds.std_y)


def lm_tokens(gen, *, batch: int, seq: int, vocab: int,
              zipf_a: float = 1.2) -> torch.Tensor:
    """Zipf-distributed synthetic token stream (batch, seq + 1), int64, so
    that embedding gathers see a realistic rank-frequency profile.

    ``gen`` is a ``torch.Generator`` (the tokens land on its device) or a
    ``numpy.random.Generator`` (CPU tokens, for tests that feed the same
    stream to both packages)."""
    if isinstance(gen, torch.Generator):
        u = torch.rand((batch, seq + 1), generator=gen, device=gen.device,
                       dtype=torch.float64) * (1.0 - 1e-6) + 1e-6
    else:
        u = torch.from_numpy(gen.uniform(1e-6, 1.0, size=(batch, seq + 1)))
    ranks = torch.floor(u ** (-1.0 / (zipf_a - 1.0)))
    return torch.clamp(ranks, 0, vocab - 1).to(torch.int64)
