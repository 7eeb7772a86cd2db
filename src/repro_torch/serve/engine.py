"""Batched serving engine with continuous batching.

Port of ``repro.serve.engine``.  A fixed pool of B decode slots shares one
batched KV cache.  Requests queue up; whenever a slot frees, the next request
is prefilled, its cache spliced into the batch cache at the slot index, and
decoding proceeds for all slots in lock-step: one ``decode_step`` per engine
tick.

The semantics follow the reference: ``max_new_tokens=1`` emits exactly one
token, EOS counts on the token sampled at prefill, ``max_ticks`` raises
``EngineIncomplete`` instead of truncating, and the admit queue is a deque.
Unlike the reference, which finds a cache leaf's batch axis by its shape
(and splices the wrong axis when ``n_units == batch_slots``), the splice
names the batch axis: 1 for the stacked unit caches, 0 for the tail's.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import model as M

UNIT_BATCH_AXIS = 1                  # unit caches: [n_units, B, ...]
TAIL_BATCH_AXIS = 0                  # tail caches: [B, ...]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: torch.Tensor             # [S] integer token ids
    max_new_tokens: int = 16
    eos_id: int = -2                 # improbable default: run to max tokens


@dataclasses.dataclass
class Finished:
    uid: int
    tokens: List[int]


class EngineIncomplete(RuntimeError):
    """``run_to_completion`` hit ``max_ticks`` with work still pending.

    The partial results are *not* silently returned: requests still queued
    or mid-decode would be dropped on the floor.  The exception carries
    everything the caller needs to decide (drain with more ticks, report,
    or accept ``finished`` explicitly)."""

    def __init__(self, finished: List[Finished], n_queued: int,
                 n_in_flight: int, max_ticks: int):
        self.finished = finished
        self.n_queued = n_queued
        self.n_in_flight = n_in_flight
        self.max_ticks = max_ticks
        super().__init__(
            f"engine incomplete after {max_ticks} ticks: "
            f"{n_queued} request(s) still queued, "
            f"{n_in_flight} still in flight "
            f"({len(finished)} finished)")


def _splice(batch_tree, single_tree, slot, axis):
    """Copy batch row 0 of ``single_tree`` into row ``slot`` of
    ``batch_tree`` along the named batch ``axis``, in place."""
    if isinstance(batch_tree, dict):
        for k in batch_tree:
            _splice(batch_tree[k], single_tree[k], slot, axis)
    else:
        batch_tree.select(axis, slot).copy_(single_tree.select(axis, 0))


class Engine:
    def __init__(self, cfg, params, batch_slots: int, cache_len: int,
                 ctx: M.Ctx = M.Ctx(), dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg, self.params, self.ctx = cfg, params, ctx
        self.B, self.cache_len = batch_slots, cache_len
        self.state = M.init_decode_state(cfg, batch_slots, cache_len, dtype,
                                         self.device)
        self.cur_tok = torch.zeros((batch_slots,), dtype=torch.int32,
                                   device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_budget = [0] * batch_slots
        self.queue: Deque[Request] = collections.deque()
        self.finished: List[Finished] = []
        # host seconds per prefill (to the sampled token) and per decode tick
        # (to the tokens on the host); both end in a read that waits for the
        # device, so no extra synchronisation is added
        self.timings = {"prefill": [], "decode": []}

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _splice_slot(self, slot: int, logits, pstate):
        """Insert a prefilled request's cache into the batch cache."""
        caches, single = self.state["caches"], pstate["caches"]
        _splice(caches["units"], single["units"], slot, UNIT_BATCH_AXIS)
        for batch_c, single_c in zip(caches["tail"], single["tail"]):
            _splice(batch_c, single_c, slot, TAIL_BATCH_AXIS)
        self.state["pos"][slot] = pstate["pos"][0]
        tok = int(torch.argmax(logits[0]))
        self.cur_tok[slot] = tok
        return tok

    def _finish_slot(self, slot: int):
        req = self.slot_req[slot]
        self.finished.append(Finished(req.uid, self.slot_out[slot]))
        self.slot_req[slot] = None
        self.slot_out[slot] = []

    def _admit(self):
        for slot in range(self.B):
            # loop: a request whose budget is exhausted at admit time (or
            # whose prefill-sampled token is already EOS) finishes
            # immediately and frees the slot for the next queued request
            # within the same admit pass.
            while self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                t0 = time.perf_counter()
                prompt = torch.as_tensor(req.prompt, device=self.device)
                logits, pstate = M.prefill(self.cfg, self.params,
                                           prompt[None, :], self.cache_len,
                                           self.ctx)
                tok = self._splice_slot(slot, logits, pstate)
                self.timings["prefill"].append(time.perf_counter() - t0)
                self.slot_req[slot] = req
                self.slot_out[slot] = [tok]
                # the prefill-sampled token is the first emitted token, so
                # only max_new_tokens - 1 decode steps remain.
                self.slot_budget[slot] = req.max_new_tokens - 1
                if self.slot_budget[slot] <= 0 or tok == req.eos_id:
                    self._finish_slot(slot)

    def tick(self) -> int:
        """One engine iteration: admit, decode one token for all slots."""
        self._admit()
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return 0
        t0 = time.perf_counter()
        logits, self.state = M.decode_step(self.cfg, self.params,
                                           self.cur_tok, self.state, self.ctx)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self.cur_tok = next_tok
        toks = next_tok.tolist()
        self.timings["decode"].append(time.perf_counter() - t0)
        for s in active:
            tok = toks[s]
            self.slot_out[s].append(tok)
            self.slot_budget[s] -= 1
            req = self.slot_req[s]
            if self.slot_budget[s] <= 0 or tok == req.eos_id:
                self._finish_slot(s)
        return len(active)

    def run_to_completion(self, max_ticks: int = 10_000) -> List[Finished]:
        ticks = 0
        while self.queue or any(r is not None for r in self.slot_req):
            if ticks >= max_ticks:
                raise EngineIncomplete(
                    self.finished, len(self.queue),
                    sum(r is not None for r in self.slot_req), max_ticks)
            self.tick()
            ticks += 1
        return self.finished
