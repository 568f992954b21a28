# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Step timing and structured metrics.

Counterpart of `tiny_deepspeed_tpu/utils/profiling.py`, its `StepTimer`
and `MetricsLogger` (`comm_report` and `trace` are not ported yet,
ROADMAP.md):

- `StepTimer`: per-step wall time closed by a device sync — the step's
  observed output (the loss, or the telemetry health vector) copied to
  the host, which waits for the device work before it; `mark(name)`
  splits the wall into `<name>_s` segments and the rest into
  `compute_s`; tail quantiles over the warm steps.  `compiled_steps`
  counts the lowerings each step paid for in JAX; eager PyTorch compiles
  nothing, so it reads 0 every step.
- `MetricsLogger`: rank-0 JSONL step records and `kind`-tagged meta
  records, the schema of `telemetry/schema.py`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


def _rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    for v in x:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def device_sync(x) -> float:
    """Barrier: copy one element of x's first tensor to the host; returns
    it as a float."""
    return float(_first_tensor(x).detach().reshape(-1)[:1].cpu()[0])


def _quantile(xs, q: float) -> float:
    """Linear-interpolated quantile of a list."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    if len(ys) == 1:
        return ys[0]
    pos = q * (len(ys) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (pos - lo)


class StepTimer:
    """Rolling per-step timing: `with timer.step() as t: ...`.

    - `mark(name)` inside the step closes the wall segment `<name>_s`;
      the tail after the last mark — the dispatched device work and the
      sync — lands in `compute_s`.  Per-step dicts in `segments`;
    - `observe(out)` registers the output to sync on before the clock
      stops; `fetch_full=True` copies the whole observed tensor (<= 1024
      elements) to the host in `last_host` — one transfer that closes the
      clock and delivers the telemetry health vector; `last_value` is
      element 0;
    - `compiled_steps` holds 0 a step: eager PyTorch compiles nothing;
    - a step whose body raises drops its observed output and records no
      sample;
    - `p50_s` / `p95_s` / `p99_s` / `max_s` / `mean_s` over the steps
      after the first.
    """

    def __init__(self, sync_every: int = 1, fetch_full: bool = False):
        self.sync_every = sync_every
        self.fetch_full = fetch_full
        self.times = []
        self.segments = []
        self.compiled_steps = []
        self.last_value = None
        self.last_host = None
        self._last_out = None
        self._segs = {}
        self._seg_t0 = 0.0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        self._seg_t0 = t0
        self._segs = {}
        try:
            yield self
        except BaseException:
            self._last_out = None
            raise
        if self._last_out is not None:
            leaf = _first_tensor(self._last_out).detach()
            if self.fetch_full and leaf.numel() <= 1024:
                host = leaf.reshape(-1).cpu().numpy()
            else:
                host = leaf.reshape(-1)[:1].cpu().numpy()
            self.last_host = host
            self.last_value = float(host[0])
            self._last_out = None
        now = time.perf_counter()
        if self._segs:
            self._segs["compute_s"] = now - self._seg_t0
            self.segments.append(self._segs)
        self.times.append(now - t0)
        self.compiled_steps.append(0)
        self._segs = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self._segs[f"{name}_s"] = now - self._seg_t0
        self._seg_t0 = now

    def observe(self, out):
        self._last_out = out
        return out

    def _sample(self):
        # the first step pays the kernels' builds and first launches
        return self.times[1:] if len(self.times) > 1 else self.times

    @property
    def mean_s(self) -> float:
        xs = self._sample()
        return sum(xs) / max(1, len(xs))

    @property
    def p50_s(self) -> float:
        return _quantile(self._sample(), 0.50)

    @property
    def p95_s(self) -> float:
        return _quantile(self._sample(), 0.95)

    @property
    def p99_s(self) -> float:
        return _quantile(self._sample(), 0.99)

    @property
    def max_s(self) -> float:
        xs = self._sample()
        return max(xs) if xs else 0.0

    @property
    def compile_count(self) -> int:
        return sum(self.compiled_steps)


class MetricsLogger:
    """Rank-0 structured metrics: a JSONL file and/or stdout; a context
    manager, so the file cannot leak when the loop raises."""

    def __init__(self, path: Optional[str] = None, stdout: bool = True):
        self.is_rank0 = _rank0()
        self.stdout = stdout
        self._fh = None
        if path and self.is_rank0:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._fh = open(path, "a")

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def log(self, step: int, **metrics) -> None:
        if not self.is_rank0:
            return
        rec = {"step": step, "ts": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout:
            shown = " ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in metrics.items())
            print(f"step {step:5d} {shown}")

    def log_meta(self, kind: str = "run_meta", **fields) -> None:
        """One `kind`-tagged record — JSONL only, never echoed."""
        if not self.is_rank0 or not self._fh:
            return
        rec = {"kind": kind, "ts": time.time(), **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
