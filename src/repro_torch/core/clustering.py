"""Parallelized co-clustering of (D_m, U_m) — Remark 2 after Def. 5; port of
``repro.core.clustering``.

pPIC's local correction helps only if y_{D_m} and Y_{U_m} are correlated, so
training and test inputs must be co-located per machine. The paper's scheme:
each machine proposes one random center from its block, centers are shared
(all-gather), every point goes to its nearest center subject to the capacity
constraint |D_i| <= |D|/M, |U_i| <= |U|/M.

This is a data-pipeline step (host-side, before sharding), so it stays in
NumPy, as in the reference: capacity-constrained nearest-center assignment
is a greedy fill in best-distance order. Only ``block_centroids``, a field
of the fitted state, runs in torch on the state's device.

The reference draws the proposals from a JAX key; here they come from an
explicit ``numpy.random.Generator`` (or a seed). The two streams differ, so
parity tests hand both packages the same centers.
"""
from __future__ import annotations

import numpy as np
import torch


def propose_centers(X: np.ndarray, M: int, rng) -> np.ndarray:
    """Each machine m picks one random center from its block (Def. 1
    layout). ``rng`` is a ``numpy.random.Generator`` or a seed."""
    X = np.asarray(X)
    b = X.shape[0] // M
    offs = np.random.default_rng(rng).integers(0, b, size=M)
    return X[offs + np.arange(M) * b]


def capacity_assign(X: np.ndarray, centers: np.ndarray,
                    capacity: int) -> np.ndarray:
    """Greedy capacity-constrained nearest-center assignment.

    Points are processed in order of their best-center distance (closest
    first); a full machine falls through to the next-nearest center.
    Returns machine id per point; no machine exceeds ``capacity``, and when
    ``n == M * capacity`` every machine is filled exactly.
    """
    n, M = X.shape[0], centers.shape[0]
    if n > M * capacity:
        raise ValueError(
            f"M * capacity = {M * capacity} cannot hold n = {n} points")
    d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)   # (n, M)
    pref = np.argsort(d2, axis=1)                               # (n, M)
    order = np.argsort(d2.min(axis=1))
    assign = np.full(n, -1, np.int64)
    load = np.zeros(M, np.int64)
    for p in order:
        for c in pref[p]:
            if load[c] < capacity:
                assign[p] = c
                load[c] += 1
                break
    return assign


def cocluster(X: np.ndarray, y: np.ndarray, U: np.ndarray, M: int, rng):
    """Full Remark-2 scheme. Returns permuted (X, y, U) in block layout plus
    the permutations (so predictions can be un-permuted). ``rng`` is a
    ``numpy.random.Generator`` or a seed."""
    X, y, U = np.asarray(X), np.asarray(y), np.asarray(U)
    centers = propose_centers(X, M, rng)
    a_d = capacity_assign(X, centers, X.shape[0] // M)
    a_u = capacity_assign(U, centers, U.shape[0] // M)
    perm_d = np.argsort(a_d, kind="stable")
    perm_u = np.argsort(a_u, kind="stable")
    return X[perm_d], y[perm_d], U[perm_u], perm_d, perm_u


def uncluster(values: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Invert a cocluster permutation on per-point outputs."""
    out = np.empty_like(values)
    out[perm] = values
    return out


def nearest_center_np(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(n,) index of each row's nearest center — host-side NumPy.

    The host mirror of ``ppic.route_queries`` (same centers, same
    squared-distance argmin): the routed plan decides every row's block on
    the host, before any device work.
    """
    X, centers = np.asarray(X), np.asarray(centers)
    d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return d2.argmin(axis=1)


def block_centroids(Xb: torch.Tensor) -> torch.Tensor:
    """(M, b, d) block layout -> (M, d) per-block data centroids, on the
    blocks' device: the routing targets cached in ``api.PICState`` (a query
    goes to the block whose centroid it is nearest)."""
    return torch.mean(Xb, dim=1)
