# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Training engines and their process groups (counterpart of
`tiny_deepspeed_tpu/parallel/`): single device, DDP, ZeRO-1, ZeRO-2 and
ZeRO-3, with ring attention or Ulysses over a sequence split, and the
in-step collective schedule (`schedule.py`: the bucketed gradient release,
ZeRO-3's gather prefetch, 2-hop gather and hpZ) and its int8/fp8
gradient codecs (`comm.py`)."""

from .engine import (DDP, SingleDevice, TrainState, Zero1, Zero2, Zero3,
                     ZeroEngine)
from .mesh import ParallelContext, init_distributed, make_context
from .partition import partition_sizes, partition_tensors
from .schedule import (GatherSlot, GradSlot, Schedule,
                       ScheduleConflictError, build_schedule,
                       parse_sched_spec)

__all__ = ["DDP", "GatherSlot", "GradSlot", "ParallelContext", "Schedule",
           "ScheduleConflictError", "SingleDevice", "TrainState", "Zero1",
           "Zero2", "Zero3", "ZeroEngine", "build_schedule",
           "init_distributed", "make_context", "parse_sched_spec",
           "partition_sizes", "partition_tensors"]
