# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Optimizer base: name-keyed, over flat {name: tensor} dicts.

Counterpart of `tiny_deepspeed_tpu/optim/base.py`, with the same API:
`init(params) -> {"step", "state"}` and `update(params, grads, state) ->
(params, state)`, a Python loop over the named parameters calling the
per-name hooks.  Unlike the JAX package, whose arrays are immutable, the
port updates parameters and moments IN PLACE (under `torch.no_grad()`):
`update` returns the same tensors it was given, so the model's
`nn.Parameter`s stay the training state and no second copy of the
parameters or moments is ever allocated.  The step counter is a host int
(the JAX package keeps an int32 array), which `lr` schedules read as a
plain Python number.
"""

from __future__ import annotations

from typing import Dict

import torch


class Optimizer:
    """Subclasses implement `init_one` and `update_one` per named param.

    `lr` is either a float or a `step -> lr` schedule from
    optim/schedule.py, resolved per step by `_lr(step)`."""

    def __init__(self, lr):
        self.lr = lr

    def _lr(self, step: int) -> float:
        return self.lr(step) if callable(self.lr) else self.lr

    # -- per-parameter hooks ----------------------------------------------

    def init_one(self, name: str, param: torch.Tensor) -> Dict:
        """Return this param's state dict (e.g. {'m': ..., 'v': ...})."""
        raise NotImplementedError

    def update_one(self, name: str, param: torch.Tensor, grad: torch.Tensor,
                   state: Dict, step: int) -> None:
        """Update `param` and `state` in place for step `step` (1-based)."""
        raise NotImplementedError

    # -- dict API ----------------------------------------------------------

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {"step": 0,
                "state": {n: self.init_one(n, p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], opt_state: Dict):
        """One step over every named param, in place; returns (params,
        opt_state), the same objects, with opt_state["step"] advanced."""
        step = opt_state["step"] + 1
        for n, p in params.items():
            self.update_one(n, p, grads[n], opt_state["state"][n], step)
        opt_state["step"] = step
        return params, opt_state
