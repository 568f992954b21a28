# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""RuntimeAutoTuner: time candidate implementations, cache the winner per
(shape, dtype).

Counterpart of `tiny_deepspeed_tpu/autotuner/runtime_tuner.py`, the
whole surface: `choose` / `choose_function`, `pending` and
`resolve_pending`, `final_tune` / `frozen`, `version`, the diagnostics
(`attach_diagnostics`: the `autotune_candidate_failures` counter and
gauge, `run_meta` records carrying `autotune`), `save` / `load` (JAX's
v2 envelope {"version": 2, "winners", "plans"}; the legacy flat table on
load), `store_plan` / `get_plan`, `plan_key`, `plan_hash`, `tune_e2e`
and the process-default tuner.

In PyTorch idiom:

- a key is (the candidates' qualified names, ((shape, dtype) | None,
  ...)), the dtype a `torch.dtype`, written to the cache file as
  PyTorch's name ("torch.bfloat16"); a Python scalar argument enters as
  its type name, so the optimizer's step counter does not make every
  step a new key.  A JAX cache file therefore resolves to no live
  candidate and is ignored — JAX's own "a stored name must match a live
  candidate" contract;
- `_synthesize` draws normal f32 values cast to the dtype from a
  `torch.Generator` on the arguments' device, seeded 0 (zeros for
  integer dtypes, 1 for a Python scalar);
- `_time_one` is JAX's wall clock: `warmup` calls, a sync, then `iters`
  calls on the host clock, ending in `torch.cuda.synchronize()` on a
  CUDA device where JAX transfers one element to the host.  The sync
  sits inside the `try`, so an asynchronous launch error lands on the
  candidate that caused it: that candidate scores `inf` and is counted
  (`failures`, kept with or without a telemetry sink).  One exception:
  a hand-written kernel's entry (marked with `hand_kernel`) that fails
  on CUDA arguments RAISES — the port's kernels launch on the card or
  raise, and a kernel that does not build or launch must not hide
  behind the plain version a site would then cache and save.

JAX times at trace time and, when `choose` sees tracers, RECORDS the
request and returns `candidates[0]` (:197-201).  The port has no trace:
`deferring()` is the context in which `choose` records instead of
timing.  The port enters it wherever the JAX package runs a jitted
program — `ZeroEngine.step` and `eval_loss`, `ServingEngine.tick`,
`GPT2Model.generate` — so no candidate is ever timed in the middle of a
step, a tick or a remat recompute; `resolve_pending()` (through
`ZeroEngine.retune()`) times the requests afterwards.  Outside the
context `choose` times at once, as JAX does on concrete arrays.

A cache hit is one dict lookup with a key built from the candidate
tuple's cached names and the arguments' shapes: every dispatch site
passes a module-level tuple of candidates.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# > 0 while inside `deferring()`
_DEFERRING = 0
# candidate tuple -> their qualified names (the key's first half)
_NAMES: Dict[Tuple, Tuple[str, ...]] = {}


@contextlib.contextmanager
def deferring():
    """While inside, `choose` records unresolved requests in `pending`
    and returns `candidates[0]` instead of timing (JAX's in-trace rule)."""
    global _DEFERRING
    _DEFERRING += 1
    try:
        yield
    finally:
        _DEFERRING -= 1


def qualname(fn: Callable) -> str:
    """The name a key and a cache file know a candidate by."""
    return fn.__module__ + "." + fn.__name__


def _device(args) -> torch.device:
    """The first tensor argument's device (the CPU without one)."""
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def hand_kernel(fn: Callable) -> Callable:
    """Mark a candidate as a hand-written kernel's entry: its failure on
    CUDA arguments is raised by `_time_one`, never scored away."""
    fn.hand_kernel = True
    return fn


def _names(candidates: Tuple) -> Tuple[str, ...]:
    names = _NAMES.get(candidates)
    if names is None:
        names = _NAMES[candidates] = tuple(qualname(c) for c in candidates)
    return names


class RuntimeAutoTuner:
    def __init__(self, warmup: int = 2, iters: int = 5,
                 verbose: bool = False, telemetry=None, logger=None):
        self.warmup = warmup
        self.iters = iters
        self.verbose = verbose
        # diagnostics sinks (attach_diagnostics): decisions become
        # `run_meta` records on the MetricsLogger, candidate failures a
        # Telemetry counter + gauge
        self.telemetry = telemetry
        self.logger = logger
        self.cache: Dict[Tuple, Callable] = {}
        # key -> (candidates, arg signature, static kwargs, device):
        # requests made inside `deferring()`, to be timed by
        # resolve_pending()
        self.pending: Dict[Tuple, Tuple] = {}
        self.frozen = False
        # (candidate qualified name, exception type name) for every
        # candidate that raised while timed
        self.failures: List[Tuple[str, str]] = []
        # bumped whenever TIMING produces a new winner (not on stored
        # hits)
        self.version = 0

    # -- key / input synthesis --------------------------------------------

    @staticmethod
    def _sig(args) -> Tuple:
        # a plain loop, the shape as its torch.Size (a tuple) and the
        # dtype object itself (its name only in the cache file): a cache
        # hit's whole cost on the host is building this
        out = []
        for a in args:
            if isinstance(a, torch.Tensor):
                out.append((a.shape, a.dtype))
            elif a is None:
                out.append(None)
            else:
                out.append(type(a).__name__)
        return tuple(out)

    @classmethod
    def _key(cls, candidates: Sequence[Callable], args) -> Tuple:
        return (_names(tuple(candidates)), cls._sig(args))

    @staticmethod
    def _synthesize(args, device=None):
        """Concrete stand-ins for args (tensors, or `_sig` entries from a
        pending record), same shape and dtype, on `device` (default the
        first tensor's)."""
        if device is None:
            device = _device(args)
        gen = torch.Generator(device=device).manual_seed(0)
        out = []
        for a in args:
            if a is None:
                out.append(None)
                continue
            if isinstance(a, str):  # a Python scalar's type name
                out.append({"int": 1, "float": 1.0, "bool": True}[a])
                continue
            if not isinstance(a, torch.Tensor) and not isinstance(a, tuple):
                out.append(type(a)(1))
                continue
            shape, dtype = (a if isinstance(a, tuple)
                            else (tuple(a.shape), a.dtype))
            if dtype.is_floating_point:
                out.append(torch.randn(shape, generator=gen,
                                       dtype=torch.float32,
                                       device=device).to(dtype))
            else:
                out.append(torch.zeros(shape, dtype=dtype, device=device))
        return tuple(out)

    def attach_diagnostics(self, telemetry=None, logger=None) -> None:
        """Route diagnostics into the run's observability surface:
        `telemetry` (a Telemetry registry) receives the
        autotune_candidate_failures counter / gauge, `logger` (a
        MetricsLogger) one `run_meta` record per timing decision."""
        if telemetry is not None:
            self.telemetry = telemetry
        if logger is not None:
            self.logger = logger

    def _diag_failure(self, fn: Callable, exc: BaseException) -> None:
        """One candidate refused these shapes: count it where dashboards
        look."""
        self.failures.append((qualname(fn), type(exc).__name__))
        if self.telemetry is not None:
            n = self.telemetry.counter("autotune_candidate_failures").inc()
            self.telemetry.gauge("autotune_candidate_failures", float(n))
        if self.logger is not None:
            self.logger.log_meta(
                kind="run_meta",
                autotune={"event": "candidate_failed",
                          "candidate": fn.__name__,
                          "error": type(exc).__name__})
        elif self.verbose:
            print(f"autotuner: {fn.__name__} failed: {type(exc).__name__}")

    def _diag_decision(self, candidates, times, best: int) -> None:
        """One timing decision: the ranking becomes a `run_meta` record
        (and a printed line only without a logger)."""
        if self.logger is not None:
            self.logger.log_meta(
                kind="run_meta",
                autotune={
                    "event": "decision",
                    "winner": candidates[best].__name__,
                    "ranking": [
                        {"candidate": c.__name__,
                         "us": None if t == float("inf")
                         else round(t * 1e6, 1)}
                        for c, t in zip(candidates, times)],
                })
        elif self.verbose:
            ranking = ", ".join(f"{c.__name__}={t * 1e6:.0f}us"
                                for c, t in zip(candidates, times))
            print(f"autotuner: {ranking} -> {candidates[best].__name__}")

    def _time_one(self, fn: Callable, concrete, static_kwargs) -> float:
        cuda = _on_card(concrete)

        def sync():
            if cuda:
                torch.cuda.synchronize()

        try:
            with torch.no_grad():
                for _ in range(self.warmup):
                    fn(*concrete, **static_kwargs)
                sync()
                t0 = time.perf_counter()
                for _ in range(self.iters):
                    fn(*concrete, **static_kwargs)
                sync()
            return (time.perf_counter() - t0) / self.iters
        except Exception as e:  # the candidate refuses these shapes
            self._diag_failure(fn, e)
            if cuda and getattr(fn, "hand_kernel", False):
                raise
            return float("inf")

    # -- public API --------------------------------------------------------

    def choose(self, candidates: Sequence[Callable], args,
               **static_kwargs) -> Callable:
        """Pick the fastest candidate for these argument shapes (cached).
        Inside `deferring()` an unresolved request is recorded and
        `candidates[0]` returned."""
        if len(candidates) == 1:
            return candidates[0]
        key = self._key(candidates, args)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        stored = getattr(self, "_stored", None)
        if stored and key in stored:  # ahead-of-time cache hit (load())
            name = stored[key]
            for c in candidates:
                if qualname(c) == name:
                    self.cache[key] = c
                    return c
        if self.frozen:
            return candidates[0]
        if _DEFERRING:
            self.pending.setdefault(
                key, (list(candidates), key[1], dict(static_kwargs),
                      _device(args)))
            return candidates[0]
        return self._pick(list(candidates), args, static_kwargs, key)

    def _pick(self, candidates, args_or_sig, static_kwargs, key,
              device=None) -> Callable:
        concrete = self._synthesize(args_or_sig, device)
        times = [self._time_one(c, concrete, static_kwargs)
                 for c in candidates]
        best = min(range(len(times)), key=times.__getitem__)
        if times[best] == float("inf"):
            best = 0
        self._diag_decision(candidates, times, best)
        self.cache[key] = candidates[best]
        self.version += 1
        return candidates[best]

    def resolve_pending(self) -> int:
        """Time every request recorded inside `deferring()` (call it
        outside) and cache the winners; returns the number resolved.  The
        sites read the cache at their next call: there is no program to
        rebuild."""
        n = 0
        for key, (candidates, sig, kw, device) in list(self.pending.items()):
            del self.pending[key]
            if key in self.cache:
                continue
            self._pick(candidates, sig, kw, key, device)
            n += 1
        return n

    # reference API name (JAX runtime_tuner.py:262)
    choose_function = choose

    def final_tune(self) -> None:
        """Freeze: no further timing; cached winners stay."""
        self.frozen = True

    # -- persistence: ahead-of-time autotune cache --------------------------

    def winner_table(self) -> Dict[Tuple, str]:
        """{key: winner qualified name}: what `save` writes (loaded
        entries not re-hit this run included)."""
        table = dict(getattr(self, "_stored", {}))
        table.update({key: qualname(fn) for key, fn in self.cache.items()})
        return table

    def save(self, path: str) -> int:
        """Write the winner table (and any tuned plans) as JSON in JAX's
        v2 envelope; returns the winner entries written."""
        table = {json.dumps(key, default=str): name
                 for key, name in self.winner_table().items()}
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": 2, "winners": table,
                       "plans": dict(getattr(self, "_plans", {}))},
                      f, indent=1)
        return len(table)

    def load(self, path: str) -> int:
        """Read a winner table (either format); entries resolve lazily at
        choose() time, against the live candidates.  Returns entries
        read."""
        def tuplify(x):
            if isinstance(x, list):
                return tuple(tuplify(i) for i in x)
            if isinstance(x, str) and x.startswith("torch."):
                dt = getattr(torch, x[6:], None)  # a dtype's name
                return dt if isinstance(dt, torch.dtype) else x
            return x

        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if isinstance(data, dict) and data.get("version") == 2:
            table = data.get("winners", {})
            self._plans = dict(data.get("plans", {}))
        else:  # legacy flat winner table
            table = data
        self._stored = {tuplify(json.loads(key_s)): name
                        for key_s, name in table.items()}
        return len(self._stored)

    def adopt(self, table: Dict[Tuple, str]) -> int:
        """Settle every pending request with another tuner's winner table
        (`winner_table()`), with no timing: the named winner, or
        candidates[0] for a key the table lacks.  How a multi-rank
        `retune` makes every rank's choice rank 0's.  Returns the
        requests settled."""
        n = 0
        for key, (candidates, *_) in list(self.pending.items()):
            del self.pending[key]
            name = table.get(key)
            self.cache[key] = next(
                (c for c in candidates if qualname(c) == name),
                candidates[0])
            n += 1
        if n:
            self.version += 1
        return n

    # -- end-to-end tuned plans ---------------------------------------------

    def store_plan(self, key: str, plan: Dict,
                   record: Optional[Dict] = None, merge: bool = False) -> str:
        """Remember `plan` for `key` (use plan_key()); `record` carries
        the measured evidence.  merge=True folds both into an existing
        entry.  Returns the plan hash."""
        plans = getattr(self, "_plans", None)
        if plans is None:
            plans = self._plans = {}
        if merge and key in plans:
            plan = {**plans[key].get("plan", {}), **plan}
            record = {**plans[key].get("record", {}), **(record or {})}
        plans[key] = {"plan": dict(plan), "hash": plan_hash(plan),
                      "record": dict(record or {})}
        return plans[key]["hash"]

    def get_plan(self, key: str) -> Optional[Dict]:
        """The stored plan entry for `key` ({"plan", "hash", "record"}),
        or None."""
        return getattr(self, "_plans", {}).get(key)


# ---------------------------------------------------------------------------
# tune_e2e: one search over a knob space against an end-to-end objective
# (JAX :364-470)
# ---------------------------------------------------------------------------


def plan_key(model: str, mesh: str, backend: str) -> str:
    """Canonical plan-store key: a plan tuned on one (model, mesh,
    backend) must never silently apply to another."""
    return f"{model}|{mesh}|{backend}"


def plan_hash(plan: Dict) -> str:
    """Short stable hash of a knob assignment."""
    s = json.dumps(plan, sort_keys=True, default=str)
    return hashlib.sha256(s.encode()).hexdigest()[:12]


def tune_e2e(measure: Callable[[Dict], float], space: Dict[str, Sequence],
             *, objective: str = "min", rounds: int = 1,
             start: Optional[Dict] = None, on_trial=None):
    """Greedy coordinate-descent search of `space` ({knob: [values...]},
    first value = the default) against `measure(plan) -> float`;
    `objective` "min" or "max".  Returns (best_plan, best_score, trials),
    trials every measured {"plan", "score"} in order (trials[0] the
    default).  A measure() that raises scores that plan worst."""
    if objective not in ("min", "max"):
        raise ValueError(f"objective must be 'min' or 'max': {objective!r}")
    sign = 1.0 if objective == "min" else -1.0
    worst = float("inf")

    def same(a, b):
        # knob values compare by type too: 1 and True differ
        return type(a) is type(b) and a == b

    def run(plan):
        try:
            s = float(measure(dict(plan)))
        except Exception:
            return worst
        if on_trial is not None:
            on_trial(dict(plan), s)
        return sign * s

    best = {k: vs[0] for k, vs in space.items()}
    if start:
        best.update({k: v for k, v in start.items() if k in space})
    trials: List[Dict] = []

    def record(plan, signed):
        trials.append({"plan": dict(plan),
                       "score": None if signed == worst else sign * signed})

    best_score = run(best)
    record(best, best_score)
    for _ in range(max(1, rounds)):
        improved = False
        for knob, values in space.items():
            for v in values:
                if same(v, best[knob]):
                    continue
                cand = dict(best, **{knob: v})
                s = run(cand)
                record(cand, s)
                if s < best_score:
                    best, best_score, improved = cand, s, True
        if not improved:
            break
    if best_score == worst:
        raise RuntimeError(
            "tune_e2e: every candidate plan failed to measure — the "
            "objective itself is broken, not the knob space")
    return best, sign * best_score, trials


_default_tuner: Optional[RuntimeAutoTuner] = None


def get_default_tuner() -> Optional[RuntimeAutoTuner]:
    return _default_tuner


def set_default_tuner(tuner: Optional[RuntimeAutoTuner]) -> None:
    """Install the process-wide tuner the dispatch sites consult
    (`linear_forward` also takes a per-call one)."""
    global _default_tuner
    _default_tuner = tuner
