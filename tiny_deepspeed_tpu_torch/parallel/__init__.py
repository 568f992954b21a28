# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Training engines (counterpart of `tiny_deepspeed_tpu/parallel/`):
single device so far."""

from .engine import SingleDevice, TrainState

__all__ = ["SingleDevice", "TrainState"]
