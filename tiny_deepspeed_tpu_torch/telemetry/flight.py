# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Flight recorder: a ring of the last N steps' health state, flushed to
a JSONL `flight` record for the postmortem.

Counterpart of `tiny_deepspeed_tpu/telemetry/flight.py` (the port's own
copy: it imports nothing of the JAX package).  When the anomaly
detector of `Telemetry` fires — on a slow step or on non-finite health —
the ring is flushed as one `kind="flight"` record (telemetry/schema.py),
so the postmortem has the N steps LEADING UP to the event.

Hot-path contract: `record()` stores references only — the per-layer
health matrix (a device tensor in layers mode) is NOT synced; the one
host transfer a step stays the health vector's, which closes the step
clock.  Only `snapshot()` / `flush()` copy device data to the host, and
they run on the anomaly path at logging cadence, never per step.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .health import first_nonfinite_layer

DEFAULT_CAPACITY = 64


class FlightRecorder:
    """Fixed-size ring of per-step entries; `flush()` writes them as one
    `flight` meta record through a MetricsLogger."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[Optional[dict]] = [None] * self.capacity
        self._n = 0          # total records ever (ring head = _n % capacity)
        self.flushes = 0

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def record(self, step: int, *, step_s: Optional[float] = None,
               health: Optional[Dict[str, float]] = None,
               segments: Optional[Dict[str, float]] = None,
               layers=None) -> None:
        """Append one step.  `health` / `segments` are host dicts (already
        paid for by the step's own sync); `layers` may be a device tensor
        — it is stored as it is, un-synced."""
        self._buf[self._n % self.capacity] = {
            "step": int(step),
            "ts": time.time(),
            "step_s": step_s,
            "health": dict(health) if health else None,
            "segments": dict(segments) if segments else None,
            "layers": layers,
        }
        self._n += 1

    def snapshot(self) -> List[dict]:
        """Oldest-to-newest JSON-safe copies of the ring; the layer
        matrices are copied to the host HERE (off the hot path) and gain a
        `first_nonfinite_layer` localization."""
        out = []
        start = max(0, self._n - self.capacity)
        for i in range(start, self._n):
            e = dict(self._buf[i % self.capacity])
            lay = e.pop("layers", None)
            for k in [k for k, v in e.items() if v is None]:
                del e[k]
            if lay is not None:
                if isinstance(lay, torch.Tensor):
                    lay = lay.detach().cpu().double().numpy()
                mat = np.asarray(lay, dtype=np.float64)
                e["layers"] = [[round(float(v), 6) for v in row]
                               for row in mat]
                src = first_nonfinite_layer(mat)
                if src is not None:
                    e["first_nonfinite_layer"] = src[0]
                    e["nonfinite_field"] = src[1]
            out.append(e)
        return out

    def flush(self, logger, reason: str, **extra) -> List[dict]:
        """Write the ring as one `kind="flight"` meta record (schema.py)
        and return the snapshot.  The ring is NOT cleared: a later, worse
        anomaly still sees the steps between the two flushes."""
        steps = self.snapshot()
        rec = {"reason": reason, "steps": steps, **extra}
        last_src = next(
            (s["first_nonfinite_layer"] for s in reversed(steps)
             if "first_nonfinite_layer" in s), None)
        if last_src is not None:
            rec.setdefault("first_nonfinite_layer", last_src)
        logger.log_meta(kind="flight", **rec)
        self.flushes += 1
        return steps
