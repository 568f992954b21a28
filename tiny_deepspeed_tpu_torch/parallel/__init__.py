# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Training engines and their process groups (counterpart of
`tiny_deepspeed_tpu/parallel/`): single device, DDP, ZeRO-1 and ZeRO-2,
with ring attention over a sequence split."""

from .engine import (DDP, SingleDevice, TrainState, Zero1, Zero2, Zero3,
                     ZeroEngine)
from .mesh import ParallelContext, init_distributed, make_context
from .partition import partition_sizes, partition_tensors

__all__ = ["DDP", "ParallelContext", "SingleDevice", "TrainState", "Zero1",
           "Zero2", "Zero3", "ZeroEngine", "init_distributed",
           "make_context", "partition_sizes", "partition_tensors"]
