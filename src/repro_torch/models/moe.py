"""Mixture-of-Experts FFN with top-k routing (Mixtral / Qwen3-MoE / Jamba) —
port of ``repro.models.moe``.

The reference dispatches through one-hot tensors: GShard's (G, n, E, C)
dispatch and combine einsums ("einsum"), or a stable sort by expert
("gather"). The two modes keep different tokens when an expert overflows
its capacity C: "einsum" ranks a group's (token, choice) pairs k-major
(every token's first choice before any second choice), "gather"
token-major (the flat (n, k) order). At qwen3-moe's prefill of 4 x 4096
tokens the einsum mode's (G, n, k, E, C) one-hot alone would be 2.1e10
elements, so the port builds no one-hot. Each pair's slot within its expert
is its rank among that expert's pairs in the mode's priority order (one
stable sort); the kept tokens are copied into an (E, G * C, d) buffer, the
experts run as batched products over E, and each token gathers its k
outputs back, weighted by its gates. Same tokens, slots and drops as the
reference's formulation in either mode; nothing syncs with the host.

The expert SwiGLU is a plain batched product (``torch.matmul``): the JAX
package runs it outside any Pallas kernel, and it has no MoE kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_normal, wide

DISPATCH = ("einsum", "gather")


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, device, dtype=torch.float32) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "router": init_normal((d_model, n_experts), gen, device, dtype, s_in),
        "w_gate": init_normal((n_experts, d_model, d_ff), gen, device, dtype,
                              s_in),
        "w_in": init_normal((n_experts, d_model, d_ff), gen, device, dtype,
                            s_in),
        "w_out": init_normal((n_experts, d_ff, d_model), gen, device, dtype,
                             s_out),
    }


def route(params: dict, tokens: torch.Tensor, top_k: int):
    """tokens (G, n, d) -> (probs (G, n, E), gate_vals (G, n, k)
    renormalized, gate_idx (G, n, k)); the router in float32 (float64 for
    float64 tokens)."""
    f32 = wide(tokens.dtype)
    logits = tokens.to(f32) @ params["router"].to(f32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def positions(gate_idx: torch.Tensor, n_experts: int,
              dispatch: str) -> torch.Tensor:
    """Each (token, choice)'s position within its expert, (G, n, k): its
    rank among the group's pairs that chose that expert, in the mode's
    priority order (k-major for "einsum", token-major for "gather")."""
    G, n, k = gate_idx.shape
    flat = (gate_idx.transpose(1, 2) if dispatch == "einsum"
            else gate_idx).reshape(G, n * k)
    expert, order = torch.sort(flat, dim=1, stable=True)
    counts = torch.zeros((G, n_experts), dtype=torch.long,
                         device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(n * k, device=flat.device)[None]
            - torch.gather(starts, 1, expert))
    pos = torch.empty_like(flat).scatter_(1, order, rank)
    if dispatch == "einsum":
        return pos.reshape(G, k, n).transpose(1, 2)
    return pos.reshape(G, n, k)


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has in a group of ``n_tokens`` tokens."""
    return max(int(n_tokens * top_k / n_experts * capacity_factor), top_k)


def expert_ffn(params: dict, xe: torch.Tensor, compute_dtype) -> torch.Tensor:
    """xe: (E, m, d) -> (E, m, d), each expert's SwiGLU on its m rows."""
    g = torch.matmul(xe, params["w_gate"].to(compute_dtype))
    h = torch.matmul(xe, params["w_in"].to(compute_dtype))
    act = F.silu(g.to(wide(compute_dtype))).to(compute_dtype) * h
    return torch.matmul(act, params["w_out"].to(compute_dtype))


def _dispatch(params: dict, x: torch.Tensor, top_k: int,
              capacity_factor: float, G: int, dispatch: str, compute_dtype):
    """Route x (B, T, d) in G groups and run the experts: (y in x's dtype,
    probs (G, n, E), gate_idx (G, n, k), keep (G, n, k))."""
    B, T, d = x.shape
    E = params["router"].shape[1]
    N = B * T
    n = N // G
    C = capacity(n, top_k, E, capacity_factor)
    tokens = x.reshape(G, n, d)
    probs, gate_vals, gate_idx = route(params, tokens, top_k)

    pos = positions(gate_idx, E, dispatch)                    # (G, n, k)
    keep = pos < C
    if dispatch == "einsum":
        keep = keep & (gate_vals > 0)
    # slot in the (E, G, C) buffer; a dropped pair goes to the spare row
    group = torch.arange(G, device=x.device)[:, None, None]
    slot = torch.where(keep, (gate_idx * G + group) * C + pos, E * G * C)

    buf = torch.zeros((E * G * C + 1, d), dtype=compute_dtype,
                      device=x.device)
    src = tokens.to(compute_dtype).reshape(N, d)
    for j in range(top_k):
        buf.index_copy_(0, slot[..., j].reshape(N), src)
    ye = expert_ffn(params, buf[:-1].view(E, G * C, d), compute_dtype)
    ye = ye.reshape(E * G * C, d)

    # combine: a dropped pair reads row 0 with weight 0
    f32 = wide(compute_dtype)
    weight = (gate_vals * keep).to(f32)
    row = torch.where(keep, slot, 0)
    y = torch.zeros((N, d), dtype=f32, device=x.device)
    for j in range(top_k):
        y += (ye.index_select(0, row[..., j].reshape(N)).to(f32)
              * weight[..., j].reshape(N, 1))
    return y.reshape(B, T, d).to(x.dtype), probs, gate_idx, keep


def _first_choices(gate_idx: torch.Tensor, E: int, dtype) -> torch.Tensor:
    """(E,) tokens whose first choice each expert is."""
    first = torch.zeros((E,), dtype=dtype, device=gate_idx.device)
    idx = gate_idx[..., 0].reshape(-1)
    return first.scatter_add_(0, idx, torch.ones(idx.shape, dtype=dtype,
                                                 device=idx.device))


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, n_groups: int = 1,
            dispatch: str = "einsum", compute_dtype=torch.bfloat16,
            rows=None) -> tuple[torch.Tensor, MoEAux]:
    """x: (B, T, d) -> (y, MoEAux), the reference's function in either
    ``dispatch`` mode. Tokens are routed in ``n_groups`` groups (one when
    B * T does not divide), each with C = max(int(n k / E cf), k) slots
    an expert; a pair past its expert's C (or, in the einsum mode, with a
    zero gate) is dropped.

    ``rows``: the mesh axes x's batch rows are split over (a
    ``parallel.sharding.AxisGroup``; x holds this rank's rows). The result
    is this rank's rows of the function of the whole batch. When every rank
    holds whole groups, each routes its own groups and the ranks sum their
    routing statistics for the aux losses; otherwise the tokens are
    gathered and every rank routes the whole batch."""
    if dispatch not in DISPATCH:
        raise ValueError(f"dispatch must be one of {DISPATCH}; got "
                         f"{dispatch!r}")
    B, T, d = x.shape
    E = params["router"].shape[1]
    R = 1 if rows is None else rows.size
    N = B * T * R
    G = n_groups if N % n_groups == 0 else 1
    if R > 1 and G % R:
        y, aux = moe_ffn(params, rows.gather(x, 0), top_k=top_k,
                         capacity_factor=capacity_factor, n_groups=G,
                         dispatch=dispatch, compute_dtype=compute_dtype)
        return y.narrow(0, rows.index * B, B), aux
    y, probs, gate_idx, keep = _dispatch(params, x, top_k, capacity_factor,
                                         G // R, dispatch, compute_dtype)
    if R == 1:
        me = probs.mean(dim=(0, 1))
        first = _first_choices(gate_idx, E, torch.float32)
        lb = E * torch.sum(me * first / N)
        dropped = 1.0 - keep.to(torch.float32).mean()
        return y, MoEAux(lb, dropped)
    # the statistics of the whole batch: each rank's sums, summed in rank
    # order (the probabilities' with their gradient)
    counts = torch.stack([keep.sum().to(probs.dtype),
                          probs.new_full((), keep.numel())])
    local = torch.cat([probs.sum(dim=(0, 1)),
                       _first_choices(gate_idx, E, probs.dtype), counts])
    tot = rows.sum(local)
    me, first = tot[:E] / N, tot[E:2 * E]
    lb = E * torch.sum(me * first / N)
    dropped = 1.0 - tot[2 * E] / tot[2 * E + 1]
    return y, MoEAux(lb, dropped)
