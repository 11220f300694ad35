"""Wave-style continuous batching for split-inference serving.

Iteration-level scheduler, with the reference's semantics: requests are
admitted into fixed slots, prompts are left-padded with ``pad_id`` to the
wave's longest prompt (the pad tokens are attended to, as in the
reference), decode runs lockstep over the slot batch at one shared
position, and finished slots are refilled at wave boundaries.  A wave stops
when every request hit ``eos_id`` or ``max_new_tokens``, or the shared
position reached ``max_len - 1``.

Each decode step brings the argmax tokens to the host once; the position
stays a host int, and the model fills the device-side ``cur_len`` itself.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.api import ModelBundle

__all__ = ["Request", "BatchStats", "WaveBatcher"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class BatchStats:
    waves: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    completed: int = 0
    slot_occupancy: list[float] = field(default_factory=list)


class WaveBatcher:
    """Runs on the device that holds ``params``."""

    def __init__(self, bundle: ModelBundle, params: Any, *, max_batch: int = 8,
                 max_len: int = 256, pad_id: int = 0):
        self.bundle = bundle
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.pad_id = pad_id
        self.queue: deque[Request] = deque()
        self.stats = BatchStats()
        self.device = params["embed"].device

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _next_wave(self) -> list[Request]:
        wave = []
        while self.queue and len(wave) < self.max_batch:
            wave.append(self.queue.popleft())
        return wave

    def run(self) -> BatchStats:
        """Drain the queue; returns aggregate stats."""
        while self.queue:
            wave = self._next_wave()
            self.stats.waves += 1
            self.stats.slot_occupancy.append(len(wave) / self.max_batch)
            plen = max(len(r.prompt) for r in wave)
            b = len(wave)
            toks = np.full((b, plen), self.pad_id, np.int32)
            for i, r in enumerate(wave):
                toks[i, plen - len(r.prompt):] = r.prompt     # left-pad
            self.stats.prefill_tokens += b * plen

            logits, cache = self.bundle.prefill(
                self.params, {"tokens": torch.as_tensor(toks, device=self.device)},
                max_len=self.max_len)
            pos = plen
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            live = np.ones(b, bool)
            budget = max(r.max_new_tokens for r in wave)
            for _ in range(budget):
                nxt_np = nxt.cpu().numpy()
                for i, r in enumerate(wave):
                    if live[i] and not r.done:
                        tok = int(nxt_np[i])
                        r.output.append(tok)
                        if (r.eos_id is not None and tok == r.eos_id) or \
                                len(r.output) >= r.max_new_tokens:
                            r.done = True
                            live[i] = False
                if not live.any() or pos >= self.max_len - 1:
                    break
                logits, cache = self.bundle.decode(self.params, cache, nxt, pos)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                pos += 1
                self.stats.decode_steps += 1
            for r in wave:
                r.done = True
                self.stats.completed += 1
        return self.stats
