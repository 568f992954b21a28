# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Decode-health guard: quarantine poisoned slots, watchdog the engine.

A copy of `tiny_deepspeed_tpu/serving/guard.py` (pure Python; the port
keeps its own copy rather than importing the JAX package).  The decode
step reduces each slot's logits to a per-slot non-finite flag that the
host reads with the sampled tokens; a poisoned slot's request is marked
`failed` while the rest keep serving, and K consecutive poisoned ticks
(or an exception out of a tick) warm-restart the engine.
"""

from __future__ import annotations

from typing import List, Sequence


class DecodeHealthGuard:
    """Per-tick decode-health bookkeeping.

    `observe(bad, active)` takes the per-slot non-finite flags and the
    active slot indices and returns the slots to quarantine (only ACTIVE
    slots — invalid slots compute on scratch garbage by design).
    `should_restart` latches after `k_restart` consecutive poisoned ticks;
    the engine calls `reset()` after the warm restart it triggers."""

    def __init__(self, k_restart: int = 3):
        if k_restart < 1:
            raise ValueError("k_restart must be >= 1")
        self.k_restart = int(k_restart)
        self.consecutive_poisoned = 0
        self.quarantined_total = 0

    def observe(self, bad: Sequence[bool],
                active: Sequence[int]) -> List[int]:
        poisoned = [i for i in active if bool(bad[i])]
        if poisoned:
            self.consecutive_poisoned += 1
            self.quarantined_total += len(poisoned)
        else:
            self.consecutive_poisoned = 0
        return poisoned

    @property
    def should_restart(self) -> bool:
        return self.consecutive_poisoned >= self.k_restart

    def reset(self) -> None:
        self.consecutive_poisoned = 0
