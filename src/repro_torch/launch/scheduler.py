"""Continuous batching for LM serving — port of ``repro.launch.scheduler``.

Requests arrive with their own prompt and output lengths, and a batch that
waited for its longest request would leave most of its rows idle. The
batcher keeps a fixed pool of slots, each holding one request in flight:

  * every slot has its own batch-1 ``ServeState`` at ``max_len``
    (``transformer.init_serve``), on the batcher's device;
  * a tick feeds one token to each busy slot through
    ``transformer.decode_step``, first the prompt's tokens, then the
    generated ones (token-level scheduling, as Orca does);
  * a slot whose request finished (``max_new`` tokens, ``eos_id``, or a
    full cache) is released, and the next tick refills it from the queue.

A tick is one ``decode_step`` call a busy slot, made one after another from
the host, and choosing each token (``argmax``, or a draw from the
batcher's seeded ``torch.Generator``) reads it back to the host. The slots
are not fused into one batched state.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    fed: int = 0                 # prompt tokens already fed

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatcher:
    """Slot-based continuous batching over per-slot decode steps.

    ``params`` live on ``device`` (the card unless another is named). Greedy
    decoding by default; with ``greedy=False`` each token is drawn with
    ``torch.multinomial`` from the softmax of its logits, from one
    generator seeded by ``seed``."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None,
                 greedy: bool = True, seed: int = 0, device=None):
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len = slots, max_len
        self.eos_id, self.greedy = eos_id, greedy
        self.device = _device.resolve(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.queue: deque[Request] = deque()
        self.slots = [_Slot() for _ in range(slots)]
        self.states = [self._new_state() for _ in range(slots)]
        self.finished: list[Request] = []

    def _new_state(self) -> tf.ServeState:
        return tf.init_serve(self.cfg, 1, self.max_len, device=self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _refill(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                slot.req = self.queue.popleft()
                slot.fed = 0
                self.states[i] = self._new_state()

    def _release(self, i: int) -> None:
        self.slots[i].req.done = True
        self.finished.append(self.slots[i].req)
        self.slots[i] = _Slot()

    def _step(self, i: int, tok: int):
        token = torch.tensor([[tok]], dtype=torch.long, device=self.device)
        logits, self.states[i] = tf.decode_step(self.params, token,
                                                self.states[i], self.cfg)
        return logits

    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One scheduling step: each busy slot consumes one token (prompt
        feed or generation). Returns the number of busy slots."""
        self._refill()
        active = 0
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            active += 1
            req = slot.req
            if slot.fed < len(req.prompt):                  # prefill phase
                tok = req.prompt[slot.fed]
                slot.fed += 1
                logits = self._step(i, tok)
                if slot.fed == len(req.prompt):
                    self._emit(i, logits)
            else:                                           # decode phase
                self._emit(i, self._step(i, req.out[-1]))
            if (len(req.out) >= req.max_new
                    or (self.eos_id is not None and req.out
                        and req.out[-1] == self.eos_id)
                    or slot.fed + len(req.out) >= self.max_len - 1):
                self._release(i)
        return active

    def _emit(self, i: int, logits: torch.Tensor) -> None:
        last = logits[0, -1]
        if self.greedy:
            tok = int(torch.argmax(last))
        else:
            probs = torch.softmax(last.to(torch.float32), dim=-1)
            tok = int(torch.multinomial(probs, 1, generator=self.generator))
        self.slots[i].req.out.append(tok)

    # ------------------------------------------------------------------
    def run(self, max_ticks: int = 10_000) -> list[Request]:
        ticks = 0
        while (self.queue or any(not s.free for s in self.slots)) \
                and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished
