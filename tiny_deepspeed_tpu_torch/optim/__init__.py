# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Name-keyed optimizers (counterpart of `tiny_deepspeed_tpu/optim/`)."""

from . import schedule
from .adamw import AdamW
from .base import Optimizer
from .schedule import (SCHEDULES, constant, inverse_sqrt, warmup_cosine,
                       warmup_linear)
from .sgd import SGD

__all__ = ["Optimizer", "SGD", "AdamW", "schedule", "SCHEDULES",
           "constant", "warmup_linear", "warmup_cosine", "inverse_sqrt"]
