# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Continuous batching over the paged KV pool, in PyTorch.

Counterpart of `tiny_deepspeed_tpu/serving/engine.py`, restricted to the
plain path.  A FIXED array of `max_active` slots decodes one token per
active slot per tick; between ticks the scheduler admits queued requests
(a bucket-padded prefill through the training forward's `return_kv` hook,
K/V scattered into the request's pool blocks), evicts finished ones and
returns their blocks to the free list.  Block exhaustion preempts the
YOUNGEST active request, which re-queues at the front and later
re-prefills prompt + tokens so far — an exact continuation.

Kept from the JAX engine: submit / tick / drain, deadlines and shedding
(`max_queue`, `shed_pool_util`, the measured per-token decode price), the
decode-health guard with quarantine and warm restart, `max_seq_tokens`
sizing, and the determinism guarantee (sampling streams keyed only by
request seed and output position).  The JAX programs are jitted with the
pool view DONATED; here the pool is updated in place by the prefill
scatter and the decode appends.

Refused with a ValueError (queued in ROADMAP.md): speculative decoding,
the prefix cache, tenants, quantized pools, the request journal and
`recover`, the flight recorder, the live plane and SLO trackers,
telemetry and the metrics logger, and KV handoff between engines.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.gpt2 import resolved_cache_dtype
from ..models.sampling import sample_logits_at, sample_logits_per_slot
from ..ops.dispatch import resolve_device
from .guard import DecodeHealthGuard
from .pool import SCRATCH_BLOCK, PagedKVPool, page_ref

# decode-wall samples needed before deadline shedding trusts its price
_MIN_GAP_SAMPLES = 5


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (JAX serving/engine.py:149).  `num_blocks` *
    `block_tokens` is the pool's token capacity; `max_active` the decode
    step's slot count.  The fields after `guard_k_restart` exist so a
    configuration written for the JAX engine is refused loudly, not run
    without its feature."""

    max_active: int = 4
    num_blocks: int = 32
    block_tokens: int = 16
    quant: Optional[str] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    seed: int = 0
    max_seq_tokens: Optional[int] = None
    max_queue: Optional[int] = None
    shed_pool_util: Optional[float] = None
    health_guard: bool = True
    guard_k_restart: int = 3
    # -- not ported yet (refused when set) --
    flight_ticks: int = 0
    spec_draft: Optional[str] = None
    prefix_cache: bool = False
    tenants: Optional[dict] = None


def _refuse(feature: str):
    raise ValueError(
        f"{feature} is not ported to the PyTorch serving engine yet "
        "(ROADMAP.md, queue of remaining modules)")


class Request:
    """One generation request: queued -> active -> done (bouncing back to
    queued on preemption or warm restart).  `status` is the terminal
    outcome: "ok", "shed", "expired" or "failed".  Times are
    time.monotonic()."""

    _ids = itertools.count()

    def __init__(self, prompt: Sequence[int], max_new_tokens: int, *,
                 deadline_s: Optional[float] = None,
                 seed: Optional[int] = None):
        self.id = next(Request._ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.seed = self.id if seed is None else int(seed)
        self.tokens: List[int] = []
        self.state = "queued"
        self.status: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.preemptions = 0
        self.t_arrival = time.monotonic()
        self.t_first: Optional[float] = None  # time to first token - arrival
        self.t_done: Optional[float] = None

    @property
    def deadline(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.t_arrival + self.deadline_s


class _Slot:
    """An active request's coordinates: its block table and current cache
    length (== the next write position)."""

    def __init__(self, req: Request, table: List[int], pos: int,
                 last_token: int, admitted_at: float):
        self.req = req
        self.table = table
        self.pos = pos
        self.last = last_token
        self.admitted_at = admitted_at


class ServingEngine:
    """Continuous-batching inference over one GPT2Model (weights in the
    model).  Runs on `device`: the card unless the caller passes
    device="cpu"; without CUDA and without a device it raises."""

    def __init__(self, model, config: ServeConfig = ServeConfig(), *,
                 device: Union[None, str, torch.device] = None,
                 telemetry=None, logger=None, journal=None):
        for name, val in (("telemetry", telemetry), ("logger", logger),
                          ("journal", journal)):
            if val is not None:
                _refuse(f"{name}=")
        if config.spec_draft is not None:
            _refuse("speculative decoding (spec_draft)")
        if config.prefix_cache:
            _refuse("the shared-prefix cache (prefix_cache)")
        if config.tenants is not None:
            _refuse("multi-tenant admission (tenants)")
        if config.flight_ticks:
            _refuse("the serving flight recorder (flight_ticks)")
        if config.quant is not None:
            _refuse(f"the quantized KV pool (quant={config.quant!r})")
        if not getattr(model, "paged_decode_capable", False):
            raise ValueError(f"{type(model).__name__} does not support the "
                             "paged decode step")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        c = model.config
        if c.block_size % config.block_tokens:
            raise ValueError(
                f"block_tokens={config.block_tokens} must divide the model "
                f"context block_size={c.block_size}")
        if config.max_active < 1:
            raise ValueError("max_active must be >= 1")
        self.model = model
        self.config = config
        self.max_seq = config.max_seq_tokens or c.block_size
        if not 1 <= self.max_seq <= c.block_size:
            raise ValueError(
                f"max_seq_tokens={config.max_seq_tokens} must be in "
                f"[1, block_size={c.block_size}]")
        self._pool_args = dict(
            n_layer=c.n_layer, kv_heads=getattr(c, "kv_heads", c.n_head),
            head_dim=c.head_dim, num_blocks=config.num_blocks,
            block_tokens=config.block_tokens,
            dtype=resolved_cache_dtype(c), device=self.device)
        self.pool = PagedKVPool(**self._pool_args)
        self.max_blocks_per_req = -(-self.max_seq // config.block_tokens)
        self._slots: List[Optional[_Slot]] = [None] * config.max_active
        self._queue: Deque[Request] = deque()
        self._guard = (DecodeHealthGuard(config.guard_k_restart)
                       if config.health_guard else None)
        self._restarts = 0
        self._restarts_since_progress = 0
        self._gap_hist: Deque[float] = deque(maxlen=128)
        self._poison_pending: set = set()
        self.last_logits = None
        # compute-dtype weights cast ONCE — params are frozen while serving
        with torch.no_grad():
            self._stacked = model.stacked_compute_params()
            self._head = model.head_compute_params()

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None) -> Request:
        """Queue one request; tokens accumulate on the returned handle.
        Above an admission watermark it comes back terminal with status
        "shed"; a malformed request raises ValueError."""
        c = self.model.config
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and >= 1 new token")
        total = len(prompt) + max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"prompt {len(prompt)} + new {max_new_tokens} tokens > "
                + (f"max_seq_tokens {self.max_seq}"
                   if self.max_seq < c.block_size
                   else f"block_size {c.block_size}"))
        worst = -(-total // self.config.block_tokens)
        if worst > self.pool.num_usable:
            raise ValueError(
                f"request needs up to {worst} blocks but the pool has "
                f"{self.pool.num_usable} — raise num_blocks or shrink the "
                "request")
        cfg = self.config
        req = Request(prompt, max_new_tokens, deadline_s=deadline_s,
                      seed=seed)
        if cfg.max_queue is not None and len(self._queue) >= cfg.max_queue:
            self._shed_req(req, "queue_watermark")
            return req
        if (cfg.shed_pool_util is not None and self._queue
                and (self.pool.blocks_in_use / self.pool.num_usable
                     >= cfg.shed_pool_util)):
            self._shed_req(req, "pool_watermark")
            return req
        self._queue.append(req)
        return req

    def tick(self) -> int:
        """One scheduler step: deadlines -> grow/preempt -> admit -> one
        decode step for every active slot -> quarantine/evict.  Returns
        the tokens produced (prefill first tokens included).  An exception
        out of the step warm-restarts the engine when the guard is on."""
        try:
            with torch.no_grad():
                produced = self._tick_body()
        except Exception as e:  # the watchdog's boundary (guard on)
            if self._guard is None:
                raise
            self._warm_restart(f"tick exception: {type(e).__name__}: {e}")
            produced = 0
        if produced:
            self._restarts_since_progress = 0
        return produced

    def drain(self, max_ticks: Optional[int] = None) -> int:
        """Tick until every submitted request is done; returns the tokens
        produced.  `max_ticks` bounds runaway loops in tests."""
        total = 0
        ticks = 0
        while self._queue or any(s is not None for s in self._slots):
            total += self.tick()
            ticks += 1
            if max_ticks is not None and ticks > max_ticks:
                raise RuntimeError(
                    f"drain exceeded {max_ticks} ticks with "
                    f"{len(self._queue)} queued")
        return total

    def recover(self, *a, **kw):
        _refuse("journal recovery (recover)")

    def export_request(self, *a, **kw):
        _refuse("KV handoff (export_request)")

    def import_request(self, *a, **kw):
        _refuse("KV handoff (import_request)")

    def attach_slo(self, tracker) -> None:
        _refuse("SLO error budgets (attach_slo)")

    def attach_live(self, aggregator) -> None:
        _refuse("the live observability plane (attach_live)")

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def restarts(self) -> int:
        return self._restarts

    def active_block_tables(self) -> dict:
        """{request id: physical block ids} for every active slot."""
        return {s.req.id: list(s.table)
                for s in self._slots if s is not None}

    def poison_slot(self, i: int) -> None:
        """Arm a NaN on slot i's logits for the NEXT decode step (the
        fault-injection hook the guard is tested with)."""
        if not 0 <= i < self.config.max_active:
            raise ValueError(f"slot {i} out of range")
        self._poison_pending.add(i)

    # -- scheduler internals ------------------------------------------------

    def _tick_body(self) -> int:
        self._enforce_deadlines(time.monotonic())
        # growth first: existing slots claim their next block before an
        # admission can take it
        self._grow()
        produced = self._admit()
        active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if active:
            produced += self._decode_plain(active)
        else:
            self._poison_pending.clear()
        return produced

    def _slot_arrays(self, active):
        """Per-slot operand vectors (empty slots carry scratch
        coordinates — branch-free, shape-stable)."""
        S = self.config.max_active
        tokens = np.zeros((S,), np.int64)
        pos = np.zeros((S,), np.int32)
        seeds = np.zeros((S,), np.int64)
        nprod = np.zeros((S,), np.int64)
        poison = np.zeros((S,), np.float32)
        tables = np.full((S, self.max_blocks_per_req), SCRATCH_BLOCK,
                         np.int32)
        for i, s in active:
            tokens[i] = s.last
            pos[i] = s.pos
            seeds[i] = s.req.seed
            nprod[i] = len(s.req.tokens)
            tables[i, :len(s.table)] = s.table
        for i in self._poison_pending:
            poison[i] = np.nan
        self._poison_pending.clear()
        return tokens, pos, seeds, nprod, poison, tables

    def _decode_step(self, tokens, pos, tables, seeds, nprod, poison):
        """The decode program: one token for every slot."""
        dev = self.device
        model, cfg = self.model, self.config
        tok = torch.from_numpy(tokens).to(dev)
        pos_t = torch.from_numpy(pos).to(dev)
        tables_t = torch.from_numpy(tables).to(dev)
        x = model._embed_decode(tok, pos_t)
        page = page_ref(tables_t, pos_t, cfg.block_tokens)
        x, _ = model.paged_decode(self._stacked, x, self.pool.view, page)
        logits = model.head(x, params=self._head)[:, 0]
        if np.isnan(poison).any():
            logits = logits + torch.from_numpy(poison).to(dev)[:, None]
        bad = ~torch.isfinite(logits).all(dim=-1)
        nxt = sample_logits_per_slot(logits, cfg.seed, seeds, nprod,
                                     cfg.temperature, cfg.top_k)
        return nxt, logits, bad

    def _decode_plain(self, active) -> int:
        produced = 0
        tokens, pos, seeds, nprod, poison, tables = self._slot_arrays(active)
        t_dec = time.monotonic()
        nxt, logits, bad = self._decode_step(tokens, pos, tables, seeds,
                                             nprod, poison)
        self.last_logits = logits
        nxt = nxt.cpu().numpy()  # the one sync per tick
        bad = bad.cpu().numpy()
        tnow = time.monotonic()
        self._gap_hist.append(tnow - t_dec)
        poisoned = (set(self._guard.observe(bad, [i for i, _ in active]))
                    if self._guard is not None else set())
        for i, s in active:
            if i in poisoned:
                self._quarantine(i, s)
                continue
            t = int(nxt[i])
            s.pos += 1
            s.last = t
            self._append_token(s.req, t, tnow)
            produced += 1
            if self._finished(s.req):
                self._finish(i, s)
        if self._guard is not None and self._guard.should_restart:
            self._warm_restart(f"{self._guard.consecutive_poisoned} "
                               "consecutive poisoned decode ticks")
        return produced

    def _gap_p50(self) -> Optional[float]:
        """Median measured decode wall per token; None until warm."""
        if len(self._gap_hist) < _MIN_GAP_SAMPLES:
            return None
        return float(np.median(np.asarray(self._gap_hist)))

    def _enforce_deadlines(self, now: float) -> None:
        """Shed queued requests that cannot meet their deadline; expire
        active ones that already blew it."""
        if any(r.deadline is not None for r in self._queue):
            gap = self._gap_p50()
            for req in list(self._queue):
                dl = req.deadline
                if dl is None:
                    continue
                reason = None
                if now >= dl:
                    reason = "deadline_overdue"
                elif gap is not None:
                    remaining = req.max_new_tokens - len(req.tokens)
                    if now + (remaining + 1) * gap > dl:  # +1: its prefill
                        reason = "deadline_unmeetable"
                if reason is not None:
                    self._queue.remove(req)
                    self._shed_req(req, reason)
        for i, s in enumerate(self._slots):
            if s is not None and s.req.deadline is not None \
                    and now > s.req.deadline:
                self._expire(i, s)

    def _bucket(self, p: int) -> int:
        """Prefill pad length: the smallest power-of-two multiple of
        block_tokens >= p."""
        bt = self.config.block_tokens
        nb = -(-p // bt)
        b = 1
        while b < nb:
            b *= 2
        return min(b * bt, self.model.config.block_size)

    def _prefill_operands(self, prompt_now: List[int], ids: List[int]):
        """(padded prompt (1, bucket), block ids (bucket/bt,)) — the +1
        decode block may lie past the bucket and is reached through the
        slot table instead."""
        p = len(prompt_now)
        bt = self.config.block_tokens
        bucket = self._bucket(p)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :p] = prompt_now
        block_ids = np.full((bucket // bt,), SCRATCH_BLOCK, np.int64)
        k = min(len(ids), bucket // bt)
        block_ids[:k] = ids[:k]
        return padded, block_ids

    def _prefill_step(self, req: Request, prompt_now: List[int],
                      ids: List[int]) -> int:
        """The prefill program: prompt through the model, K/V into the
        request's blocks, first token sampled at the true last position."""
        padded, block_ids = self._prefill_operands(prompt_now, ids)
        dev = self.device
        logits, _ = self.model.paged_prefill(
            torch.from_numpy(padded).to(dev), len(prompt_now) - 1,
            torch.from_numpy(block_ids).to(dev), self.pool.view,
            self.config.block_tokens, stacked=self._stacked,
            head_params=self._head)
        cfg = self.config
        nxt = sample_logits_at(logits, cfg.seed, req.seed, len(req.tokens),
                               cfg.temperature, cfg.top_k)
        return int(nxt[0])

    def _admit(self) -> int:
        """FIFO admission while a slot is free and the pool can hold the
        prompt plus its first decode write."""
        produced = 0
        bt = self.config.block_tokens
        while self._queue:
            try:
                slot_i = self._slots.index(None)
            except ValueError:
                break
            req = self._queue[0]
            prompt_now = req.prompt + req.tokens  # preemption continuation
            p = len(prompt_now)
            # blocks for the prompt AND its first decode write (position p)
            ids = self.pool.alloc(p // bt + 1)
            if ids is None:
                break
            self._queue.popleft()
            t_adm = time.monotonic()
            try:
                tok = self._prefill_step(req, prompt_now, ids)
            except Exception:
                # put the request back as it was, so the watchdog's
                # restart (which re-queues occupied slots only) keeps it
                self.pool.free_blocks(ids)
                self._queue.appendleft(req)
                raise
            slot = _Slot(req, table=ids, pos=p, last_token=tok,
                         admitted_at=t_adm)
            self._slots[slot_i] = slot
            req.state = "active"
            self._append_token(req, tok, time.monotonic())
            produced += 1
            if self._finished(req):
                self._finish(slot_i, slot)
        return produced

    def _grow(self) -> None:
        """Allocate the next block for any slot whose next write crossed a
        block boundary; on exhaustion preempt the youngest active request
        until the grower fits (or is itself preempted)."""
        bt = self.config.block_tokens
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            while (self._slots[i] is slot
                   and len(slot.table) < slot.pos // bt + 1):
                ids = self.pool.alloc(1)
                if ids is not None:
                    slot.table.extend(ids)
                    continue
                victim_i, victim = max(
                    ((j, s) for j, s in enumerate(self._slots)
                     if s is not None),
                    key=lambda js: js[1].admitted_at)
                self._preempt(victim_i, victim)

    def _release(self, i: int, slot: _Slot) -> None:
        self.pool.free_blocks(slot.table)
        self._slots[i] = None

    def _preempt(self, i: int, slot: _Slot) -> None:
        req = slot.req
        self._release(i, slot)
        req.state = "queued"
        req.preemptions += 1
        # front of the queue: it resumes by re-prefilling prompt + tokens
        self._queue.appendleft(req)

    def _warm_restart(self, reason: str) -> None:
        """Watchdog escalation: fresh pool and slot array, every in-flight
        request re-queued front-of-line with its produced prefix.  Raises
        after repeated restarts with no progress between them."""
        self._restarts += 1
        self._restarts_since_progress += 1
        if self._restarts_since_progress > 5:
            raise RuntimeError(
                f"serving engine warm-restarted "
                f"{self._restarts_since_progress} times without producing "
                f"a token (last reason: {reason}) — the fault is "
                "persistent; refusing to spin")
        occupied = sorted(
            ((i, s) for i, s in enumerate(self._slots) if s is not None),
            key=lambda js: js[1].admitted_at, reverse=True)
        for _, s in occupied:  # oldest admission ends up frontmost
            s.req.state = "queued"
            s.req.preemptions += 1
            self._queue.appendleft(s.req)
        self._slots = [None] * self.config.max_active
        self._poison_pending.clear()
        self.pool = PagedKVPool(**self._pool_args)
        if self._guard is not None:
            self._guard.reset()

    def _finished(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = req.finish_reason or "length"
            return True
        eos = self.config.eos_id
        if eos is not None and req.tokens and req.tokens[-1] == eos:
            req.finish_reason = "eos"
            return True
        return False

    def _finish(self, i: int, slot: _Slot) -> None:
        self._release(i, slot)
        self._terminal(slot.req, "ok", slot.req.finish_reason or "length")

    def _expire(self, i: int, slot: _Slot) -> None:
        self._release(i, slot)
        self._terminal(slot.req, "expired", "deadline")

    def _quarantine(self, i: int, slot: _Slot) -> None:
        self._release(i, slot)
        self._terminal(slot.req, "failed", "nonfinite_logits")

    def _shed_req(self, req: Request, reason: str) -> None:
        self._terminal(req, "shed", f"shed:{reason}")

    @staticmethod
    def _terminal(req: Request, status: str, finish: str) -> None:
        req.state = "done"
        req.status = status
        req.finish_reason = finish
        req.t_done = time.monotonic()

    @staticmethod
    def _append_token(req: Request, tok: int, tnow: float) -> None:
        req.tokens.append(tok)
        if req.t_first is None:
            req.t_first = tnow
