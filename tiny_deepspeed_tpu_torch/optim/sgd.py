# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""SGD with momentum/dampening/nesterov/weight-decay/maximize.

Counterpart of `tiny_deepspeed_tpu/optim/sgd.py`, with its semantics:
weight decay folded into the gradient, then maximize, then classic
momentum with the reference's zero-initialised velocity (the first step
applies (1 - dampening) * g), velocity kept in the parameter's dtype.
Math in f32; updates in place.
"""

from __future__ import annotations

import torch

from .base import Optimizer


class SGD(Optimizer):
    def __init__(self, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, maximize=False,
                 decay_exclude=()):
        super().__init__(lr)
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "nesterov requires momentum > 0 and zero dampening")
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.maximize = maximize
        self.decay_exclude = tuple(decay_exclude)

    def init_one(self, name, param):
        if self.momentum:
            return {"velocity": torch.zeros_like(param)}
        return {}

    def update_one(self, name, param, grad, state, step):
        g = grad.float()
        p = param.float()
        wd = (0.0 if any(pat in name for pat in self.decay_exclude)
              else self.weight_decay)
        if wd:
            g = g + wd * p
        if self.maximize:
            g = -g
        if self.momentum:
            buf = (self.momentum * state["velocity"].float()
                   + (1.0 - self.dampening) * g)
            state["velocity"].copy_(buf)
            g = g + self.momentum * buf if self.nesterov else buf
        param.copy_(p - self._lr(step) * g)
