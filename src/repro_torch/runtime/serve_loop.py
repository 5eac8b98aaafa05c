"""Batched serving loop with continuous batching (slot-based).

A fixed pool of B decode slots shares one ``Model.decode_step``; requests
attach to free slots and detach when finished, so short requests never wait
for long ones (continuous batching). Each slot keeps its own position
counter and every step runs all slots at their own positions (the decode
path scatters each row's k/v at its own cache slot). The KV cache is
allocated once for the pool; per-slot masking uses the cache's absolute
``pos_ids``, so interleaved slots cannot see each other, and a reused slot
cannot see its earlier request's entries.

Prompts are teacher-forced through the decode step one token at a time, as
in the JAX package's loop; the logits that follow a prompt's last token
give its first generated token.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (L,) int
    max_new: int = 16
    # filled by the loop:
    output: list = field(default_factory=list)
    done: bool = False
    submitted_s: float = 0.0
    finished_s: float = 0.0


class ServeLoop:
    """Slot-based continuous batching over ``Model.decode_step``.

    ``steps`` counts decode steps; ``tokens_stepped`` counts the tokens
    those steps consumed (one per active slot per step).
    """

    def __init__(self, model, params, n_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None, dtype=torch.float32):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.cache = model.init_cache(n_slots, max_seq, dtype=dtype)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)       # next position
        self.slot_cursor = np.zeros(n_slots, np.int64)    # prompt cursor
        self.pending: list[Request] = []
        self.steps = 0
        self.tokens_stepped = 0

    def submit(self, req: Request):
        req.submitted_s = time.time()
        self.pending.append(req)

    def _attach(self):
        for i in range(self.n_slots):
            if self.slot_req[i] is None and self.pending:
                req = self.pending.pop(0)
                self.slot_req[i] = req
                self.slot_pos[i] = 0
                self.slot_cursor[i] = 0

    def _next_tokens(self, last_logits) -> np.ndarray:
        toks = np.zeros(self.n_slots, np.int64)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            cur = int(self.slot_cursor[i])
            if cur < len(req.prompt):
                toks[i] = req.prompt[cur]              # teacher-forced prefill
            else:
                toks[i] = int(np.argmax(last_logits[i]))
        return toks

    def run(self):
        """Drive until all submitted requests finish."""
        last_logits = np.zeros((self.n_slots, self.model.cfg.vocab_size),
                               np.float32)
        while self.pending or any(r is not None for r in self.slot_req):
            self._attach()
            toks = self._next_tokens(last_logits)
            active = np.array([r is not None for r in self.slot_req])
            if not active.any():
                break
            # one step for ALL slots, each at its own position
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, torch.from_numpy(toks),
                torch.from_numpy(self.slot_pos.copy()))
            logits = logits.cpu().numpy()
            last_logits[active] = logits[active]
            self.steps += 1
            self.tokens_stepped += int(active.sum())

            # advance / retire slots
            for i, req in enumerate(self.slot_req):
                if req is None:
                    continue
                cur = int(self.slot_cursor[i])
                # the logits that follow the LAST prompt token are already
                # the first generated token
                if cur >= len(req.prompt) - 1:
                    req.output.append(int(np.argmax(last_logits[i])))
                self.slot_cursor[i] += 1
                self.slot_pos[i] += 1
                prompt_done = self.slot_cursor[i] >= len(req.prompt)
                hit_eos = (self.eos_id is not None and req.output
                           and req.output[-1] == self.eos_id)
                out_full = len(req.output) >= req.max_new
                if (prompt_done and (out_full or hit_eos)) \
                        or self.slot_pos[i] >= self.max_seq:
                    req.done = True
                    req.finished_s = time.time()
                    self.slot_req[i] = None
