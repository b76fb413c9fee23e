"""Collective-algorithm building blocks beyond the stock psum — port of
``repro.parallel.collectives``.

``ring_all_reduce`` — reduce-scatter + all-gather ring built from the
machine axis's ``ppermute``, with ``compressed=True`` an int8 payload and
its scale on every hop (the pPITC summary aggregation in low precision;
error feedback is the caller's). ``overlapped_psum_pair`` — starts the big
message before the small one so the two can overlap.

Both take the port's stacked idiom: ``x`` is this process's (L, ...) stack
of machines and ``axis_name`` the runner's machine-axis object
(``parallel.runner``). On a ``VmapRunner``'s axis a ppermute is a roll over
dim 0; across ranks it is point to point (or what ``runner.BACKEND_TABLE``
stages in its place).
"""
from __future__ import annotations

import torch


def _quantize(v: torch.Tensor):
    """Per-machine int8 payload and scale of (L, ...) rows, as the
    reference's ``maybe_q``: scale = max(max|v|, 1e-12) / 127."""
    amax = v.abs().reshape(v.shape[0], -1).amax(1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    s = scale.reshape((-1,) + (1,) * (v.dim() - 1))
    q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
    return q, scale


def ring_all_reduce(x: torch.Tensor, axis_name, *, axis_size: int,
                    compressed: bool = False) -> torch.Tensor:
    """Ring all-reduce over the machine axis ``axis_name`` (the runner's
    axis object). ``x``: (L, n, ...), each machine's rows; every machine
    receives the (n, ...) sum, as (L, n, ...). n is zero-padded to a
    multiple of ``axis_size`` chunks."""
    ax, nm = axis_name, axis_size
    if nm == 1:
        return x
    L, n = x.shape[0], x.shape[1]
    pad = (-n) % nm
    xp = torch.cat([x, x.new_zeros((L, pad) + tuple(x.shape[2:]))], 1) \
        if pad else x
    acc = xp.reshape((L, nm, -1) + tuple(x.shape[2:])).clone()
    idx = ax.index(x.device)
    rows = torch.arange(L, device=x.device)
    perm = [(i, (i + 1) % nm) for i in range(nm)]

    # reduce-scatter phase: after nm-1 hops, chunk (idx+1) holds the sum
    for step in range(nm - 1):
        payload = acc[rows, (idx - step) % nm]
        if compressed:
            q, scale = _quantize(payload)
            recv = ax.ppermute(q, perm)
            scale_r = ax.ppermute(scale, perm)
            recv = recv.to(x.dtype) * scale_r.reshape(
                (-1,) + (1,) * (recv.dim() - 1)).to(x.dtype)
        else:
            recv = ax.ppermute(payload, perm)
        recv_i = (idx - step - 1) % nm
        acc[rows, recv_i] = acc[rows, recv_i] + recv.to(acc.dtype)

    # all-gather phase: circulate the finished chunks
    for step in range(nm - 1):
        recv = ax.ppermute(acc[rows, (idx + 1 - step) % nm], perm)
        acc[rows, (idx - step) % nm] = recv

    return acc.reshape((L, -1) + tuple(x.shape[2:]))[:, :n]


def overlapped_psum_pair(big: torch.Tensor, small: torch.Tensor, axis_name):
    """psum both, the big message started first: two asynchronous
    all-reduces across ranks, then a wait on both."""
    b = axis_name.psum_start(big)
    s = axis_name.psum_start(small)
    return b.wait(), s.wait()
