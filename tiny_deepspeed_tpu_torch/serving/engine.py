# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Continuous batching over the paged KV pool, in PyTorch.

Counterpart of `tiny_deepspeed_tpu/serving/engine.py`.  A FIXED array
of `max_active` slots decodes one token per active slot per tick (or,
under speculative decoding, verifies a drafted span and commits 1 to
spec_k + 1 tokens per slot); between ticks the scheduler admits queued
requests (a bucket-padded prefill through the training forward's
`return_kv` hook, K/V scattered into the request's pool blocks), evicts
finished ones and returns their blocks to the free list.  Block
exhaustion preempts the YOUNGEST active request, which re-queues at the
front and later re-prefills prompt + tokens so far — an exact
continuation.

Kept from the JAX engine: submit / tick / drain, deadlines and shedding
(`max_queue`, `shed_pool_util`, the measured per-token decode price), the
decode-health guard with quarantine and warm restart, `max_seq_tokens`
sizing, the determinism guarantee (sampling streams keyed only by
request seed and output position), speculative decoding (`spec_draft`,
`spec_k`; serving/spec.py), the shared-prefix cache (`prefix_cache`;
serving/prefix.py: matched full blocks alias into the block table and
only the unmatched suffix is prefilled, through the span-verify path)
and int8 / fp8 pools (`quant`).  The JAX programs are jitted with the
pool view DONATED; here the pool is updated in place by the prefill
scatter, the decode appends and the span commits.

Refused with a ValueError: what the JAX engine refuses (the prefix cache
together with speculative decoding), and what is queued in ROADMAP.md —
tenants, the request journal and `recover`, the flight recorder, the
live plane and SLO trackers, telemetry and the metrics logger, and KV
handoff between engines.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, List, Optional, Sequence, Union

import numpy as np
import torch

from ..autotuner import deferring
from ..models.gpt2 import resolved_cache_dtype
from ..models.sampling import (sample_logits_at, sample_logits_per_slot,
                               spec_prefill_commit)
from ..ops.dispatch import resolve_device
from .guard import DecodeHealthGuard
from .pool import SCRATCH_BLOCK, PagedKVPool, page_ref, paged_append_span
from .prefix import PrefixCache

# decode-wall samples needed before deadline shedding trusts its price
_MIN_GAP_SAMPLES = 5


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (JAX serving/engine.py:149).  `num_blocks` *
    `block_tokens` is the pool's token capacity; `max_active` the decode
    step's slot count; `quant` rests the pool at int8 / fp8; `spec_draft`
    ("ngram", "model:self", "model:<preset>") and `spec_k` turn on
    speculative decoding; `prefix_cache` the shared-prefix cache (not
    together with spec_draft).  The fields after `prefix_cache` exist so
    a configuration written for the JAX engine is refused loudly, not run
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
    spec_draft: Optional[str] = None
    spec_k: int = 4
    prefix_cache: bool = False
    # -- not ported yet (refused when set) --
    flight_ticks: int = 0
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
        # shared-prefix cache: blocks aliased from the radix tree and the
        # prompt tokens whose prefill that avoided, over all admissions
        self.prefix_blocks = 0
        self.prefix_tokens = 0
        # speculative decoding: drafts proposed for / accepted into this
        # request's sequence
        self.spec_proposed = 0
        self.spec_accepted = 0
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
    """Continuous-batching inference over one model, GPT2Model or
    LlamaModel (weights in the model; the pool rests at the model's
    `kv_heads`).  Runs on `device`: the card unless the caller passes
    device="cpu"; without CUDA and without a device it raises."""

    def __init__(self, model, config: ServeConfig = ServeConfig(), *,
                 device: Union[None, str, torch.device] = None,
                 telemetry=None, logger=None, journal=None):
        for name, val in (("telemetry", telemetry), ("logger", logger),
                          ("journal", journal)):
            if val is not None:
                _refuse(f"{name}=")
        if config.tenants is not None:
            _refuse("multi-tenant admission (tenants)")
        if config.flight_ticks:
            _refuse("the serving flight recorder (flight_ticks)")
        if config.prefix_cache and config.spec_draft is not None:
            raise ValueError(
                "prefix_cache does not compose with spec_draft: the suffix "
                "prefill and the draft span both own the span path, and "
                "the drafter's accept-or-residual commit is not wired "
                "through the suffix path — run one or the other")
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
            dtype=resolved_cache_dtype(c), quant=config.quant,
            device=self.device)
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
        # (S, V) f32 logits of the last PLAIN decode tick (a speculative
        # engine's verify logits are consumed in the step: it leaves None)
        self.last_logits = None
        self._ticks = 0
        # shared-prefix radix tree (None = cache off; rebuilt empty with
        # the pool on warm restart)
        self._prefix = (PrefixCache(config.block_tokens)
                        if config.prefix_cache else None)
        # speculative-decoding accounting (engine lifetime)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_ticks = 0
        self._spec_tokens = 0
        # compute-dtype weights cast ONCE — params are frozen while serving
        with torch.no_grad():
            self._stacked = model.stacked_compute_params()
            self._head = model.head_compute_params()
        if config.spec_draft is not None:
            from .spec import SpecDecoder
            self._spec = SpecDecoder(model, config, max_seq=self.max_seq)
            # the span horizon: growth and admission own blocks out to
            # pos + spec_k, so accepted drafts' K/V always land in-table
            self._span_k = config.spec_k
        else:
            self._spec = None
            self._span_k = 0

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
                     >= cfg.shed_pool_util)
                and self._effective_pool_util() >= cfg.shed_pool_util):
            self._shed_req(req, "pool_watermark")
            return req
        self._queue.append(req)
        return req

    @deferring()
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
        self._ticks += 1  # the prefix tree's LRU clock
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

    def prefix_stats(self) -> Optional[dict]:
        """Shared-prefix cache outcomes (None with the cache off): hit
        rate = prompt tokens aliased / prompt tokens admitted, the raw
        counters and the pool bytes sharing saves right now (JAX
        :1149)."""
        if self._prefix is None:
            return None
        pc = self._prefix
        return {
            "hit_rate": round(pc.tokens_avoided / max(1, pc.prompt_tokens),
                              4),
            "hits": pc.hits, "misses": pc.misses,
            "blocks_aliased": pc.blocks_aliased,
            "prefill_tokens_avoided": pc.tokens_avoided,
            "prompt_tokens": pc.prompt_tokens,
            "cached_blocks": len(pc),
            "tree_evictions": pc.evicted,
            "pool_saved_bytes": self._prefix_saved_bytes(),
        }

    def _prefix_saved_bytes(self) -> int:
        """Pool bytes aliasing saves right now, from the refcounts: every
        holder beyond a block's first would need its own block."""
        excess = sum(n - 1 for n in self.pool.ref_counts().values() if n > 1)
        if not excess:
            return 0
        return int(excess * self.pool.kv_bytes()["total_bytes"]
                   / (self.pool.num_usable + 1))

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
        if active and self._spec is not None:
            produced += self._decode_spec(active)
        elif active:
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

    def _decode_spec(self, active) -> int:
        """Speculative tick (JAX :1297-1382): the drafter proposes K
        tokens per slot, ONE verify pass scores all K+1 span positions,
        and 1..K+1 tokens commit per surviving slot.  Only verified
        tokens reach the request or the pool; quarantine, the watchdog
        and the deadline price see the same per-slot surface as the
        plain path."""
        k = self._spec.k
        produced = 0
        t_draft = time.monotonic()
        drafts = self._spec.propose(self._slots)  # (S, K+1)
        tokens, pos, seeds, nprod, poison, tables = self._slot_arrays(active)
        S = self.config.max_active
        # [head, d_1..d_K, extra]: columns 0..K are the scored span, the
        # trailing extra is the bonus position's proposal
        span = np.zeros((S, k + 2), np.int64)
        span[:, 0] = tokens
        span[:, 1:] = drafts
        # the last position whose K/V the request will ever need (total-2:
        # the final token's K/V is never read); -1 parks empty slots at
        # count 0 — every write lands in scratch
        limit_kv = np.full((S,), -1, np.int64)
        for i, s in active:
            limit_kv[i] = len(s.req.prompt) + s.req.max_new_tokens - 2
        acc, final, bad = self._spec.verify(
            self._stacked, self._head, self.pool.view, span, pos, tables,
            seeds, nprod, limit_kv, poison)
        acc = acc.cpu().numpy()  # the one sync per tick
        final = final.cpu().numpy()
        bad = bad.cpu().numpy()
        tnow = time.monotonic()
        poisoned = (set(self._guard.observe(bad, [i for i, _ in active]))
                    if self._guard is not None else set())
        eos = self.config.eos_id
        committed = 0
        for i, s in active:
            if i in poisoned:
                self._quarantine(i, s)
                continue
            n_acc = int(acc[i])
            toks = [int(t) for t in span[i, 1:1 + n_acc]]
            toks.append(int(final[i]))
            toks = toks[:s.req.max_new_tokens - len(s.req.tokens)]
            if eos is not None and eos in toks:
                toks = toks[:toks.index(eos) + 1]  # keep the eos itself
            s.req.spec_proposed += k
            s.req.spec_accepted += min(n_acc, len(toks))
            self._spec_proposed += k
            self._spec_accepted += min(n_acc, len(toks))
            for t in toks:
                self._append_token(s.req, t, tnow)
            s.pos += len(toks)
            s.last = toks[-1]
            produced += len(toks)
            committed += len(toks)
            if self._finished(s.req):
                self._finish(i, s)
        # deadline price: this tick's wall per COMMITTED token
        if committed:
            self._gap_hist.append((tnow - t_draft) * len(active) / committed)
            self._spec_ticks += 1
            self._spec_tokens += committed
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

    def _bucket_span(self, n: int) -> int:
        """Suffix-prefill pad length: the smallest power of two >= n (the
        span commits through `count`, so no block multiple is needed)."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.model.config.block_size)

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
                      ids: List[int], slot_i: int = 0,
                      n_alias: int = 0) -> int:
        """The prefill program: prompt through the model, K/V into the
        request's blocks, first token sampled at the true last position.
        With `n_alias` blocks aliased from the prefix tree only the
        suffix runs (`_prefill_suffix`); a speculative engine commits
        the first token through the accept-or-residual rule against the
        drafter's proposal for that position."""
        if n_alias:
            return self._prefill_suffix(req, prompt_now, ids, n_alias)
        prop = (self._spec.on_admit(slot_i, prompt_now)
                if self._spec is not None else None)
        padded, block_ids = self._prefill_operands(prompt_now, ids)
        dev = self.device
        logits, _ = self.model.paged_prefill(
            torch.from_numpy(padded).to(dev), len(prompt_now) - 1,
            torch.from_numpy(block_ids).to(dev), self.pool.view,
            self.config.block_tokens, stacked=self._stacked,
            head_params=self._head)
        cfg = self.config
        if prop is not None:
            nxt = spec_prefill_commit(logits, prop, cfg.seed, req.seed,
                                      len(req.tokens), cfg.temperature,
                                      cfg.top_k)
        else:
            nxt = sample_logits_at(logits, cfg.seed, req.seed,
                                   len(req.tokens), cfg.temperature,
                                   cfg.top_k)
        return int(nxt[0])

    @torch.no_grad()
    def _prefill_suffix(self, req: Request, prompt_now: List[int],
                        ids: List[int], n_alias: int) -> int:
        """The suffix-prefill program (JAX :597-617): the aliased blocks
        already hold positions < p0; the unmatched suffix, padded to a
        power-of-two bucket, embeds at its absolute positions, attends to
        the aliased prefix through the block table plus itself under the
        windowed causal mask (the span-verify path), samples the first
        token at the true last prompt position, and commits its K/V
        through `paged_append_span` (pad offsets land in scratch)."""
        model, cfg, dev = self.model, self.config, self.device
        bt = cfg.block_tokens
        p0 = n_alias * bt
        suffix = prompt_now[p0:]
        k1 = self._bucket_span(len(suffix))
        span = torch.zeros((1, k1), dtype=torch.long)
        span[0, :len(suffix)] = torch.tensor(suffix)
        tables = torch.full((1, self.max_blocks_per_req), SCRATCH_BLOCK,
                            dtype=torch.int32)
        tables[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        span, tables = span.to(dev), tables.to(dev)
        pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
        positions = torch.clamp(
            p0 + torch.arange(k1, device=dev)[None, :],
            max=model.config.block_size - 1)
        x = model._embed_decode_span(span, positions)
        page = page_ref(tables, pos0, bt)
        x, sks, svs = model.paged_verify(self._stacked, x, self.pool.view,
                                         page)
        logits = model.head(x, position=len(prompt_now) - 1 - p0,
                            params=self._head)[:, 0]
        nxt = sample_logits_at(logits, cfg.seed, req.seed, len(req.tokens),
                               cfg.temperature, cfg.top_k)
        paged_append_span(self.pool.view, sks, svs, tables, pos0,
                          torch.tensor([len(suffix)], device=dev), bt)
        return int(nxt[0])

    def _alloc(self, n: int) -> Optional[List[int]]:
        """pool.alloc with prefix-tree reclaim (JAX :1480): under pressure
        the tree yields its least recently hit unreferenced leaves BEFORE
        the scheduler resorts to preemption."""
        ids = self.pool.alloc(n)
        if ids is None and self._prefix is not None:
            if self._prefix.evict(self.pool, need=n - self.pool.blocks_free):
                ids = self.pool.alloc(n)
        return ids

    def _effective_pool_util(self) -> float:
        """Pool utilization for the shed watermark: allocated blocks minus
        what the prefix tree could reclaim right now (warm cache is not
        overload)."""
        used = self.pool.blocks_in_use
        if self._prefix is not None:
            used -= self._prefix.reclaimable(self.pool)
        return used / self.pool.num_usable

    def _admit(self) -> int:
        """FIFO admission while a slot is free and the pool can hold the
        prompt plus its first decode write (JAX :1503-1664).  With the
        prefix cache on, admission first walks the radix tree: matched
        full blocks alias into the block table (refcounted) and only the
        unmatched suffix pays a prefill."""
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
            # alias at most (p-1)//bt full blocks: one prompt token always
            # remains for the suffix prefill, and every block the request
            # will WRITE stays private
            alias: List[int] = []
            if self._prefix is not None:
                alias = self._prefix.match(prompt_now, limit=(p - 1) // bt,
                                           tick=self._ticks)
                if alias:
                    # pin before allocating: the alloc may evict leaves
                    self.pool.share(alias)
            # blocks for the prompt AND its first decode write (position p;
            # under speculation the whole first span, clamped)
            ids_new = self._alloc(
                self._write_horizon(req, p) // bt + 1 - len(alias))
            if ids_new is None:
                if alias:
                    self.pool.free_blocks(alias)  # roll the pin back
                break
            ids = alias + ids_new
            self._queue.popleft()
            t_adm = time.monotonic()
            try:
                tok = self._prefill_step(req, prompt_now, ids, slot_i,
                                         len(alias))
            except Exception:
                # put the request back as it was, so the watchdog's
                # restart (which re-queues occupied slots only) keeps it
                self.pool.free_blocks(ids)
                self._queue.appendleft(req)
                raise
            if self._prefix is not None:
                # commit the prompt's full blocks to the tree: new nodes
                # take their own refcount, which keeps them warm
                self._prefix.insert(prompt_now, ids[:p // bt], self.pool,
                                    tick=self._ticks)
                self._prefix.note_admission(len(alias), p)
                req.prefix_blocks += len(alias)
                req.prefix_tokens += len(alias) * bt
            slot = _Slot(req, table=ids, pos=p, last_token=tok,
                         admitted_at=t_adm)
            self._slots[slot_i] = slot
            req.state = "active"
            self._append_token(req, tok, time.monotonic())
            produced += 1
            if self._finished(req):
                self._finish(slot_i, slot)
        return produced

    def _write_horizon(self, req: Request, pos: int) -> int:
        """The furthest position this slot's NEXT step may write (JAX
        :1666): `pos` on the plain path, `pos + spec_k` under speculation,
        clamped to the request's last writable position total-2 (the
        final token's K/V is never written)."""
        if not self._span_k:
            return pos
        total = len(req.prompt) + req.max_new_tokens
        return min(pos + self._span_k, total - 2)

    def _grow(self) -> None:
        """Allocate the next block for any slot whose write horizon
        crossed a block boundary; on exhaustion (after the prefix tree
        yields what it can) preempt the youngest active request until the
        grower fits (or is itself preempted)."""
        bt = self.config.block_tokens
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            while (self._slots[i] is slot
                   and len(slot.table)
                   < self._write_horizon(slot.req, slot.pos) // bt + 1):
                ids = self._alloc(1)
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
        if self._prefix is not None:
            # the tree indexed blocks of the pool that just died: it
            # rebuilds empty alongside (lifetime stats carry on)
            old = self._prefix
            self._prefix = PrefixCache(self.config.block_tokens)
            for attr in ("hits", "misses", "blocks_aliased",
                         "tokens_avoided", "prompt_tokens", "evicted"):
                setattr(self._prefix, attr, getattr(old, attr))
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
