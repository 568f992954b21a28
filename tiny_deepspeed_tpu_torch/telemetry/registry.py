# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The `Telemetry` registry: counters, gauges and histograms, the
instrumented step, the anomaly detector and its two postmortem channels
(one profiler trace, the flight recorder), and the measured gauges.

Counterpart of `tiny_deepspeed_tpu/telemetry/registry.py`, its step
side.  One object owns a run's telemetry:

    telem = Telemetry(trace_dir="traces")          # anomaly trace
    eng   = Zero2(model, opt, telemetry=telem)     # health vector in-step
    ...
    with telem.step(index=it) as t:                # timing + breakdown
        batch = loader.next();      t.mark("data")
        state, loss = eng.step(state, batch)       # engine pushes the aux
    metrics.log(it, loss=telem.last_health["loss"], **telem.step_record())
    telem.maybe_flush_flight(metrics)

The engine's health vector is observed as the step's closing sync, so
the one device->host transfer that stops the step clock also delivers
loss, grad / update / param norms and the non-finite count.

Not ported yet (ROADMAP.md): the parts that read XLA's compiled program
— `capture_compiled`, `run_meta`'s HLO ledger fields, `trace_spans` /
`compute_trace_spans` and `pipe_trace`.  The anomaly trace is a
`torch.profiler` capture of the step after the anomaly (a chrome trace
under `trace_dir/anomaly`), behind the same injectable
`tracer=(start, stop)` pair.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .flight import FlightRecorder
from .health import HEALTH_FIELDS, health_dict
from ..utils.profiling import StepTimer, _quantile

_GB = float(2 ** 30)


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self.value += n
            return self.value


class Histogram:
    __slots__ = ("values",)

    def __init__(self):
        self.values = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def mean(self) -> float:
        return sum(self.values) / max(1, len(self.values))

    @property
    def p50(self) -> float:
        return _quantile(self.values, 0.50)

    @property
    def p95(self) -> float:
        return _quantile(self.values, 0.95)

    @property
    def p99(self) -> float:
        return _quantile(self.values, 0.99)

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean, "p50": self.p50,
                "p95": self.p95, "p99": self.p99,
                "max": max(self.values) if self.values else 0.0}


class _ProfilerTrace:
    """The default anomaly tracer: `torch.profiler` over the CPU and, when
    there is one, the card; `stop` writes `trace.json` (chrome format)
    into the directory `start` was given."""

    def __init__(self):
        self._prof = None
        self._path = None

    def start(self, path: str) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._path = path
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(self._path, "trace.json"))


class Telemetry:
    """Run-level telemetry registry and step instrumentation.

    Anomaly capture: after `anomaly_min_steps` samples, a step slower
    than `anomaly_factor` x the rolling median ARMS the tracer; the next
    `step()` runs under it and writes ONE trace into `trace_dir` — then
    never again this run.  `tracer=(start_fn, stop_fn)` injects a pair
    (tests pass a fake).  `layers=True` turns on the engine's per-layer
    health mode; `flight_steps` sizes the flight recorder (0: none)."""

    def __init__(self, timer: Optional[StepTimer] = None,
                 trace_dir: Optional[str] = None,
                 anomaly_factor: float = 2.5, anomaly_min_steps: int = 10,
                 anomaly_window: int = 50, tracer=None,
                 layers: bool = False, flight_steps: int = 64):
        self.timer = timer or StepTimer()
        self.timer.fetch_full = True
        self.trace_dir = trace_dir
        self.anomaly_factor = float(anomaly_factor)
        self.anomaly_min_steps = int(anomaly_min_steps)
        self.anomaly_window = int(anomaly_window)
        if tracer is None:
            prof = _ProfilerTrace()
            tracer = (prof.start, prof.stop)
        self._tracer = tracer
        self.layers = bool(layers)
        self.flight = FlightRecorder(flight_steps) if flight_steps else None
        self.flight_pending: Optional[str] = None
        self._nonfinite_prev = False
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._engine = None
        self._last_aux = None
        self._last_health = None
        self._last_layers = None
        self._last_layers_host = None
        self._recent = []
        self._trace_armed = False
        self._trace_fired = False
        self.trace_path: Optional[str] = None
        self._trace_logged = False

    # -- registry ------------------------------------------------------------

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str, value=None):
        """Set (when `value` is given) and read a gauge."""
        if value is not None:
            self.gauges[name] = float(value)
        return self.gauges.get(name)

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe registry dump for the `telemetry_summary` record."""
        return {"counters": {k: c.value for k, c in self.counters.items()},
                "gauges": dict(self.gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self.histograms.items()}}

    # -- engine wiring -------------------------------------------------------

    def attach(self, engine) -> None:
        """Called by the engine built with `telemetry=self`: the memory
        gauge reads its device."""
        self._engine = engine

    def on_step_output(self, aux, layers=None) -> None:
        """Engine push: the step's (5,) health vector and, in layers mode,
        the (n_layer, 6) matrix — device tensors, NOT synced here."""
        self._last_aux = aux
        self._last_health = None
        self._last_layers = layers
        self._last_layers_host = None

    def poll(self) -> Optional[Dict[str, float]]:
        """Host view of the latest health vector (one transfer, cached)."""
        if self._last_health is None and self._last_aux is not None:
            self._last_health = health_dict(self._last_aux)
        return self._last_health

    @property
    def last_health(self) -> Optional[Dict[str, float]]:
        return self.poll()

    def layer_health(self):
        """Host view (numpy) of the latest (n_layer, 6) matrix, or None
        outside layers mode; one transfer, cached."""
        if self._last_layers_host is None and self._last_layers is not None:
            self._last_layers_host = (
                self._last_layers.detach().cpu().numpy())
        return self._last_layers_host

    # -- the instrumented step ------------------------------------------------

    @contextlib.contextmanager
    def step(self, index: Optional[int] = None):
        """Wrap one training step: timing and segment marks through the
        inner StepTimer, the health vector's sync as the closing barrier,
        the armed anomaly trace if one is pending.  `index` numbers the
        flight entries (the caller's iteration; default the steps
        counter)."""
        trace_now = (self._trace_armed and not self._trace_fired
                     and self.trace_dir is not None)
        if trace_now:
            path = os.path.join(self.trace_dir, "anomaly")
            os.makedirs(path, exist_ok=True)
            self._tracer[0](path)
        try:
            with self.timer.step() as t:
                yield t
                if self._last_aux is not None:
                    t.observe(self._last_aux)
        finally:
            if trace_now:
                self._tracer[1]()
                self._trace_fired = True
                self._trace_armed = False
                self.trace_path = path
                self.counter("anomaly_traces").inc()
        host = self.timer.last_host
        if host is not None and len(host) == len(HEALTH_FIELDS):
            self._last_health = health_dict(host)
        dt = self.timer.times[-1]
        n_step = self.counter("steps").inc()
        self.histogram("step_s").observe(dt)
        if self.timer.segments:
            for k, v in self.timer.segments[-1].items():
                self.histogram(k).observe(v)
        if self.timer.compiled_steps[-1]:
            self.counter("compiles").inc(self.timer.compiled_steps[-1])
        self.note_step_time(dt)
        h = self._last_health
        if self.flight is not None:
            self.flight.record(
                index if index is not None else n_step - 1, step_s=dt,
                health=h, segments=(self.timer.segments[-1]
                                    if self.timer.segments else None),
                layers=self._last_layers)
        bad = h is not None and (h["nonfinite_grads"]
                                 or not np.isfinite(h["loss"]))
        if bad and not self._nonfinite_prev:
            # a NaN step is not slow: non-finite health arms the flight
            # flush directly, edge-triggered (once an episode), and
            # outranks a pending slow_step
            self.counter("anomalies_nonfinite").inc()
            self.flight_pending = "nonfinite"
        self._nonfinite_prev = bad

    def note_step_time(self, s: float) -> bool:
        """Feed one step's wall time to the detector.  True exactly once a
        run: the first step over `anomaly_factor` x the rolling median
        (after the warm-up window), which arms the trace of the next step
        and the flight flush of the past ones."""
        fired = False
        if (len(self._recent) >= self.anomaly_min_steps
                and not self._trace_armed and not self._trace_fired):
            med = _quantile(self._recent, 0.5)
            if s > self.anomaly_factor * med:
                self._trace_armed = True
                self.counter("anomalies").inc()
                self.gauge("anomaly_step_s", s)
                self.gauge("anomaly_threshold_s", self.anomaly_factor * med)
                if self.flight_pending is None:
                    self.flight_pending = "slow_step"
                fired = True
        self._recent.append(float(s))
        if len(self._recent) > self.anomaly_window:
            self._recent.pop(0)
        return fired

    # -- flight recorder ------------------------------------------------------

    def maybe_flush_flight(self, logger) -> Optional[str]:
        """Flush the flight ring to `logger` iff an anomaly armed it;
        returns the reason or None.  Call at logging cadence: the flush
        copies the recorded layer matrices to the host."""
        if self.flight is None or self.flight_pending is None:
            return None
        reason = self.flight_pending
        self.flight_pending = None
        self.flight.flush(logger, reason)
        self.counter("flight_flushes").inc()
        return reason

    # -- measured gauges ------------------------------------------------------

    def sample_stragglers(self, step_s: Optional[float] = None,
                          allgather=None,
                          quantity: str = "step_s") -> Dict[str, object]:
        """Per-rank straggler attribution: all-gather one wall quantity
        (`dist.all_gather_object` over the world; local on one process;
        `allgather` injects the gather), gauge the slowest's drag and
        return the `straggler` record's fields.  `straggler_frac` =
        (slowest - median) / slowest."""
        import torch.distributed as dist
        mine = float(step_s if step_s is not None else self.timer.p50_s)
        if allgather is not None:
            times = [float(v) for v in allgather(mine)]
        elif dist.is_initialized() and dist.get_world_size() > 1:
            got = [None] * dist.get_world_size()
            dist.all_gather_object(got, mine)
            times = [float(v) for v in got]
        else:
            times = [mine]
        med = _quantile(sorted(times), 0.5)
        slowest = int(np.argmax(times))
        frac = ((times[slowest] - med) / times[slowest]
                if times[slowest] > 0 else 0.0)
        self.gauge("straggler_frac", frac)
        self.gauge("straggler_slowest_host", slowest)
        self.gauge("straggler_slowest_step_s", times[slowest])
        return {"hosts": len(times), "quantity": quantity,
                "step_s_by_host": [round(t, 6) for t in times],
                "slowest_host": slowest, "straggler_frac": round(frac, 6)}

    def _device(self):
        eng = self._engine
        dev = getattr(eng, "device", None)
        return dev if dev is not None and dev.type == "cuda" else None

    def sample_memory(self) -> Dict[str, float]:
        """The card's memory watermark (`torch.cuda.memory_stats`, in the
        JAX field names); {} on the CPU."""
        dev = self._device()
        if dev is None:
            return {}
        stats = torch.cuda.memory_stats(dev)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", in_use))
        out = {"hbm_gb_in_use": round(in_use / _GB, 4),
               "hbm_gb_peak": round(peak / _GB, 4)}
        self.gauge("hbm_gb_in_use", out["hbm_gb_in_use"])
        self.gauge("hbm_gb_peak", max(self.gauge("hbm_gb_peak") or 0.0,
                                      out["hbm_gb_peak"]))
        return out

    def sample_grad_residual(self, state) -> Optional[float]:
        """The global L2 norm of the grad-comm codec's error-feedback
        residual (this rank's row), gauged; None without one.  One host
        transfer: call at telemetry cadence."""
        res = getattr(state, "grad_residual", None)
        if res is None:
            return None
        norm = float(res.detach().double().square().sum().sqrt())
        self.gauge("grad_residual_norm", norm)
        return norm

    # -- sinks ----------------------------------------------------------------

    def step_record(self) -> Dict[str, object]:
        """Per-step JSONL fields beyond loss / step_s / tokens_per_s:
        health, the wall segments, `compiled`, the memory watermark and
        (once) the anomaly trace's path."""
        rec: Dict[str, object] = {}
        h = self.poll()
        if h is not None:
            rec.update({k: h[k] for k in HEALTH_FIELDS if k != "loss"})
        if self.timer.segments:
            rec.update(self.timer.segments[-1])
        if self.timer.compiled_steps:
            rec["compiled"] = int(self.timer.compiled_steps[-1])
        rec.update(self.sample_memory())
        if self.trace_path and not self._trace_logged:
            rec["anomaly_trace"] = self.trace_path
            self._trace_logged = True
        return rec

    def flush(self, logger) -> None:
        """The registry snapshot as a `telemetry_summary` record."""
        logger.log_meta(kind="telemetry_summary", **self.snapshot())
