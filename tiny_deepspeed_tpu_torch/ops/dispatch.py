# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Device resolution and the kernel-or-plain rule shared by every op.

The JAX package picks its kernels at trace time from the backend
(`kernel_target()`).  Here the choice follows the tensor: a wrapper
launches its hand-written kernel for a CUDA tensor and takes the plain
PyTorch version only for a CPU tensor.  There is no fallback from one to
the other — a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    card.  Without CUDA, a CUDA device (given or implied) RAISES — the
    port never drops to the CPU on its own."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or torch.cuda.is_available():
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' explicitly to run "
            "the port's plain PyTorch path on the CPU")
    return torch.device("cuda")


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the first given tensor lies on a CUDA device; raises if
    the tensors are split across device types."""
    types = {t.device.type for t in tensors if t is not None}
    if len(types) > 1:
        raise ValueError(f"operands on mixed devices: {sorted(types)}")
    return types == {"cuda"}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation type: f32, or f64 for f64 inputs
    (so `torch.autograd.gradcheck` can run them in double precision)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def require(cond: bool, msg: Union[str, Callable[[], str]]) -> None:
    """Validate a kernel operand (never `assert`: -O strips those).  A
    callable `msg` is formatted only when the check fails, which keeps a
    hot wrapper's checks off the host's clock."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)
