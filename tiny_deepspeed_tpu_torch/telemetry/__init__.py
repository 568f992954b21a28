# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""In-step training telemetry (counterpart of `tiny_deepspeed_tpu/
telemetry/`, the parts the engine's `telemetry=` knob reads):

- `health`: the on-device health vector (loss, grad / update / param
  global norms, non-finite count) and the per-layer health matrix;
- `Telemetry` (registry.py): counters, gauges, histograms, the
  instrumented step, the anomaly detector, the flight recorder's flush,
  memory and straggler gauges;
- `flight` (FlightRecorder): the ring of the last N steps' health;
- `schema`: the JSONL metrics schema, a copy of JAX's.

Not ported yet (ROADMAP.md): the HLO-ledger parts of `Telemetry`,
`trace.py`, `live.py` and `slo.py`.
"""

from . import schema
from .flight import FlightRecorder
from .health import (HEALTH_FIELDS, LAYER_FIELDS, first_nonfinite_layer,
                     health_dict, health_vector, layer_health_matrix)
from .registry import Telemetry

__all__ = ["HEALTH_FIELDS", "LAYER_FIELDS", "health_vector", "health_dict",
           "layer_health_matrix", "first_nonfinite_layer", "FlightRecorder",
           "Telemetry", "schema"]
