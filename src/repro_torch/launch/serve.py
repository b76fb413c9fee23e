"""Generation loop of the LM — port of ``prefill_then_decode`` from
``repro.launch.serve``, which also serves an enc-dec model given its
encoder's output (the loop of ``examples/lm_serve.py``, over cross K/V
projected once). The sharded serve step (``make_serve_step``,
``serve_state_specs``) waits for the LM's sharding over a mesh.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def prefill_then_decode(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                        *, max_len: int, n_decode: int,
                        temperature: float = 0.0,
                        generator: torch.Generator | None = None,
                        step_ms: list | None = None,
                        enc_kv: torch.Tensor | None = None) -> torch.Tensor:
    """Reference generation loop: the prompt goes through decode steps one
    token at a time (simple and exact, as in the reference), then
    ``n_decode`` tokens are chosen greedily, or sampled at ``temperature``
    from ``generator`` when both are given. bfloat16 compute and caches, the
    reference's defaults. Returns (B, T + n_decode).

    ``enc_kv``: an enc-dec model's encoder output (``transformer.encode``);
    every decoder layer's cross K/V are projected from it once
    (``precompute_cross_kv``) and every step attends over them.

    ``step_ms``: when a list is given, each generated token's step (choose
    the token, then the decode step) is synchronised with the device and
    its wall time in milliseconds appended to it. Per-token latency is what
    a caller of generation feels, and only this loop knows where one
    token's step begins and ends, so the measurement lives here rather
    than in a copy of the loop; without ``step_ms`` the loop makes no
    device sync.
    """
    B, T = tokens.shape
    if T + n_decode > max_len:
        raise ValueError(f"prompt {T} + {n_decode} new tokens exceed "
                         f"max_len {max_len}")
    state = tf.init_serve(cfg, B, max_len, device=tokens.device)
    if enc_kv is not None:
        state = state._replace(cross_kv=tf.precompute_cross_kv(params,
                                                               enc_kv, cfg))
    logits = None
    for t in range(T):
        logits, state = tf.decode_step(params, tokens[:, t:t + 1], state, cfg)
    out = [tokens]
    for _ in range(n_decode):
        if step_ms is not None:
            _sync(tokens.device)
            t0 = time.perf_counter()
        last = logits[:, -1]
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(last / temperature, dim=-1)
            cur = torch.multinomial(probs, 1, generator=generator)
        else:
            cur = torch.argmax(last, dim=-1, keepdim=True)
        out.append(cur.to(tokens.dtype))
        logits, state = tf.decode_step(params, cur, state, cfg)
        if step_ms is not None:
            _sync(tokens.device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return torch.cat(out, dim=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
