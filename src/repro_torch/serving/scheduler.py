"""Continuous-batching scheduler (the port of the JAX package's
``serving/scheduler.py``): request queue → slot map → ONE decode step
over a fixed ``[max_batch]`` slot array.

The decode step runs every slot at its own position (``decode_step``'s
``[B]`` pos vector) under a live mask, so requests join and finish at
any step without changing the step.  On the card the step is ONE CUDA
graph per parameter tree: captured at the first step that tree serves,
over static device buffers — ``tok [B,1]``, ``pos [B]``, ``live [B]``,
the slot cache (``serving/cache.py``, whose buffers never move) and the
parameters — and replayed every later step after three small
host-to-device copies, with one device-to-host read of the step's
``(nxt, tok, pos)``.  The first step of a tree runs eagerly on a side
stream: it is the graph's warm-up and the step itself (its result is
used), and the kernel launch counters are read around it (a replay does
not advance them).  With a :class:`HotSwapper` that is at most two
graphs (one per parameter slot), without one a single graph, whatever
the churn: ``decode_graphs()`` is the reference's ``decode_compiles()``.
A capture that fails raises; nothing falls back to eager steps on the
card.  On the CPU the same step runs eagerly and ``decode_graphs()`` is
0.

Dead slots keep computing (they re-write their own last cache entry)
and their outputs are masked off on the host; admission prefills a
request at batch 1 and copies its cache slice into a free slot.

Prefill policy: attention-only, non-windowed configs pad prompts to
power-of-two buckets ``min(next_pow2(S), max_len - 1)`` (right-pad
K/V is overwritten before it is read, under the ``idx <= pos`` mask;
the first token is ``argmax(logits[0, S - 1])``); recurrent (rwkv) or
windowed configs prefill at EXACT length, since padding would corrupt
the carried state / ring buffer.  ``prefill_shapes()`` counts the
distinct padded lengths (the reference's ``prefill_compiles()``).

Stalls + timeouts: a slot can stop making progress (a wedged device —
injected by the ``slot_stall`` fault via ``inject_stall``).  Stalled
slots are masked out of the live set; a ``request_timeout`` > 0 arms
the watchdog: a slot that makes no progress for that many scheduler
ticks is torn down and its request REQUEUED from scratch at the front
of the queue, counted in ``metrics.requeues``.  A stall with no
watchdog ends in a RuntimeError after 100,000 idle ticks.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..models import transformer as TF
from .cache import BlockTable, SlotCache
from .swap import HotSwapper
from .telemetry import ServeMetrics


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    tokens: list = dataclasses.field(default_factory=list)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[next(iter(tree))]
    return tree


def _count(into: dict, before: dict, after: dict) -> None:
    for k in after:
        if after[k] != before[k]:
            into[k] = into.get(k, 0) + after[k] - before[k]


class ServeLoop:
    def __init__(self, cfg: ModelConfig, max_batch: int, max_len: int,
                 params=None, swapper: Optional[HotSwapper] = None,
                 request_timeout: int = 0):
        """``params`` (a tree on the serving device) or ``swapper``,
        exactly one.  The cache dtype follows ``cfg.dtype``."""
        if (params is None) == (swapper is None):
            raise ValueError("pass exactly one of params / swapper")
        self.cfg, self.max_batch, self.max_len = cfg, max_batch, max_len
        self.swapper = swapper
        self._params = params
        self.device = (swapper.device if swapper is not None
                       else _first_leaf(params).device)
        self.metrics = ServeMetrics()
        # per-request watchdog: 0 = off; N = requeue a slot's request
        # after N scheduler ticks without decode progress
        self.request_timeout = request_timeout
        self.ticks = 0
        self._last_progress = np.zeros((max_batch,), np.int64)
        self._stalled_until = np.zeros((max_batch,), np.int64)
        dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
        self.cache = SlotCache(cfg, max_batch, max_len, dtype, self.device)
        self.table = BlockTable(max_batch)
        self.queue: deque = deque()
        self.done: dict = {}
        self.steps = 0
        self._next_rid = 0
        # host-side slot state (tiny [B] vectors, shipped every step)
        self._tok = np.zeros((max_batch, 1), np.int64)
        self._pos = np.zeros((max_batch,), np.int64)
        self._remaining = np.zeros((max_batch,), np.int32)
        self._req_of_slot: list = [None] * max_batch
        # the decode step's static device inputs
        self._tok_d = torch.zeros((max_batch, 1), dtype=torch.long,
                                  device=self.device)
        self._pos_d = torch.zeros((max_batch,), dtype=torch.long,
                                  device=self.device)
        self._live_d = torch.zeros((max_batch,), dtype=torch.bool,
                                   device=self.device)
        self._graphs: dict = {}     # id(params) -> (params, graph, out)
        self._prefill_lens: set = set()
        # kernel launches (ops.launches) of every prefill, and of the
        # eager decode steps (the graphs' warm-ups; CPU steps)
        self.prefill_launches: dict = {}
        self.decode_launches: dict = {}
        seg_kinds = {s.kind for s in TF.segments(cfg)}
        self._bucket_ok = (not cfg.attention.window
                           and not (seg_kinds & {"rwkv", "hybrid"}))

    # -- graph / shape counters (the pinned-count assertions ride on these)
    def decode_graphs(self) -> int:
        return len(self._graphs)

    def prefill_shapes(self) -> int:
        return len(self._prefill_lens)

    def params(self):
        return self.swapper.params() if self.swapper else self._params

    # -- the two device programs --------------------------------------
    def _prefill(self, params, toks: np.ndarray, S: int):
        small = TF.init_cache(self.cfg, 1, self.max_len, self.cache.dtype,
                              self.device)
        n0 = ops.launches()
        logits, small = TF.prefill_cache(
            self.cfg, params, torch.from_numpy(toks).to(self.device), small)
        first = int(torch.argmax(logits[0, S - 1]))
        _count(self.prefill_launches, n0, ops.launches())
        return small, first

    def _decode(self, params):
        """The decode step over the static buffers: returns [3, B]
        (next token, the slots' new tok and pos)."""
        B = self.max_batch
        logits, _ = TF.decode_step(self.cfg, params, self.cache.bufs,
                                   self._tok_d, self._pos_d)
        nxt = torch.argmax(logits.reshape(B, -1), dim=-1)
        live = self._live_d
        tok = torch.where(live[:, None], nxt[:, None], self._tok_d)
        pos = torch.where(live, torch.clamp(self._pos_d + 1,
                                            max=self.max_len - 1),
                          self._pos_d)
        return torch.stack([nxt, tok[:, 0], pos])

    def _eager(self, params):
        n0 = ops.launches()
        out = self._decode(params)
        _count(self.decode_launches, n0, ops.launches())
        return out

    def _capture(self, params):
        """The first step of ``params`` on the card: run eagerly on a
        side stream (warm-up and the step itself), then capture the
        graph that later steps replay."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._eager(params)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = self._decode(params)
        self._graphs[id(params)] = (params, graph, static_out)
        return out

    def _step(self, live_np: np.ndarray) -> np.ndarray:
        self._tok_d.copy_(torch.from_numpy(self._tok))
        self._pos_d.copy_(torch.from_numpy(self._pos))
        self._live_d.copy_(torch.from_numpy(live_np))
        params = self.params()
        if self.device.type != "cuda":
            out = self._eager(params)
        elif id(params) in self._graphs:
            _, graph, out = self._graphs[id(params)]
            graph.replay()
        else:
            out = self._capture(params)
        return out.cpu().numpy()

    # -- request lifecycle ---------------------------------------------
    def submit(self, prompt, max_new: int, rid=None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        S = prompt.shape[0]
        if S >= self.max_len:
            raise ValueError(f"prompt length {S} >= max_len {self.max_len}")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        self.queue.append(Request(rid, prompt,
                                  min(max_new, self.max_len - S)))
        return rid

    def _admit(self):
        params = self.params()
        while self.queue and self.table.free_slots:
            req = self.queue.popleft()
            slot = self.table.alloc(req.rid)
            S = req.prompt.shape[0]
            Sb = min(_next_pow2(S), self.max_len - 1) if self._bucket_ok else S
            toks = np.zeros((1, Sb), np.int64)
            toks[0, :S] = req.prompt
            self._prefill_lens.add(Sb)
            small, first = self._prefill(params, toks, S)
            self.cache.insert(small, slot)
            self.metrics.prefills += 1
            req.tokens.append(first)
            self._req_of_slot[slot] = req
            self._tok[slot, 0] = first
            self._pos[slot] = S
            self._remaining[slot] = req.max_new - 1
            self._last_progress[slot] = self.ticks
            if req.max_new <= 1:
                self._finish(slot)

    def _finish(self, slot: int):
        req = self._req_of_slot[slot]
        self._req_of_slot[slot] = None
        self._remaining[slot] = 0
        self.table.free(req.rid)
        self.done[req.rid] = np.asarray(req.tokens, np.int32)
        self.metrics.completed += 1

    # -- fault surface + watchdog --------------------------------------
    def inject_stall(self, slot: int, ticks: int) -> None:
        """Fault-injection hook (fault ``slot_stall``): mask ``slot`` out
        of the live decode set for the next ``ticks`` scheduler ticks."""
        self._stalled_until[slot] = self.ticks + ticks

    def _requeue(self, slot: int) -> None:
        """Tear down a timed-out slot and restart its request from
        scratch at the queue front (tokens discarded)."""
        req = self._req_of_slot[slot]
        self._req_of_slot[slot] = None
        self._remaining[slot] = 0
        self.table.free(req.rid)
        req.tokens = []
        self.queue.appendleft(req)
        self.metrics.requeues += 1

    def _check_timeouts(self) -> None:
        if not self.request_timeout:
            return
        for slot in range(self.max_batch):
            if (self._req_of_slot[slot] is not None
                    and self.ticks - self._last_progress[slot]
                    > self.request_timeout):
                self._requeue(slot)

    # -- main loop ------------------------------------------------------
    def run(self, on_step: Optional[Callable] = None) -> dict:
        """Drain the queue; returns {rid: generated tokens [max_new]}.

        ``on_step(loop, step_idx)`` fires after every decode step (e.g.
        publish a checkpoint mid-stream to force a hot swap)."""
        idle = 0
        while self.queue or len(self.table):
            self.ticks += 1
            self._admit()
            if self.swapper is not None:
                if self.swapper.poll():
                    self.metrics.observe_swap(self.swapper.last_stall_s)
                self.metrics.gauge("ckpt_staleness_s",
                                   self.swapper.staleness_s())
                self.metrics.gauge("quarantined_ckpts",
                                   len(self.swapper.quarantined))
            self.metrics.queue_depth = len(self.queue)
            self.metrics.active_slots = len(self.table)
            self._check_timeouts()
            live_np = ((self._remaining > 0)
                       & (self._stalled_until <= self.ticks))
            if not live_np.any():
                # nothing can decode: stalled slots (or everything
                # finished at admit).  Ticks keep advancing so stalls
                # expire and the watchdog still fires; the idle cap
                # turns a stall with no timeout into a loud error.
                idle += 1
                if idle > 100_000:
                    raise RuntimeError(
                        "serve loop wedged: no decode progress for "
                        "100000 ticks (stalled slots and no "
                        "request_timeout?)")
                continue
            idle = 0
            t0 = time.perf_counter()
            out = self._step(live_np)
            dt = time.perf_counter() - t0
            nxt = out[0]
            self._tok = out[1][:, None].copy()
            self._pos = out[2].copy()
            self.steps += 1
            self._last_progress[live_np] = self.ticks
            n_live = int(live_np.sum())
            self.metrics.observe_decode(dt, n_live)
            for slot in np.nonzero(live_np)[0]:
                req = self._req_of_slot[slot]
                req.tokens.append(int(nxt[slot]))
                self._remaining[slot] -= 1
                if self._remaining[slot] <= 0:
                    self._finish(slot)
            if on_step is not None:
                on_step(self, self.steps)
        return self.done
