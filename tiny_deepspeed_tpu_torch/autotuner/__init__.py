# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Runtime autotuner (counterpart of `tiny_deepspeed_tpu/autotuner`)."""

from .runtime_tuner import (
    RuntimeAutoTuner,
    deferring,
    get_default_tuner,
    plan_hash,
    plan_key,
    set_default_tuner,
    tune_e2e,
)

__all__ = ["RuntimeAutoTuner", "deferring", "get_default_tuner",
           "set_default_tuner", "tune_e2e", "plan_key", "plan_hash"]
