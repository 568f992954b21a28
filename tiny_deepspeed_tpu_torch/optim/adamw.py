# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""AdamW, with the JAX package's semantics.

Counterpart of `tiny_deepspeed_tpu/optim/adamw.py`:

- weight decay is L2-folded into the gradient by default
  (`decoupled=False`, the reference's math); `decoupled=True` is true
  AdamW;
- ONE global step counter drives bias correction;
- `amsgrad`, `maximize`, `decay_exclude` (name substrings with no weight
  decay) and `state_dtype` (storage of m/v/vmax) as there;
- all update math in f32, whatever the parameter and state dtypes.

The update is plain tensor code, a copy of the JAX `_xla_update`
(:202-218) and of its amsgrad tail (:169-188), run in place on the
parameter and moments (under `Optimizer.update`'s `torch.no_grad()`).

`fused=True` runs every leaf through `optim/adamw_fused.py::
adamw_update_fused` (the Triton counterpart of the Pallas one-pass
kernel `optim/adamw_pallas.py::adamw_update_pallas`, row 13 of PERF.md's
TPU kernel table): one launch per leaf, whatever its size.  Where the
JAX optimizer warns and falls back to its XLA update, the port RAISES
(the kernel has no silent fallback): `amsgrad=True` and a `state_dtype`
other than float32 at construction, a non-f32 parameter at `init_one`.
An lr schedule needs no fallback: lr and the bias corrections are the
kernel's runtime scalars, and the result is JAX's `_xla_update`, which
is what JAX runs under a schedule.  `fused="auto"` (JAX: the runtime
autotuner picks kernel or XLA per leaf) raises NotImplementedError until
the autotuner is ported.
"""

from __future__ import annotations

import math

import torch

from . import adamw_fused
from .base import Optimizer


class AdamW(Optimizer):
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-2, amsgrad=False, maximize=False,
                 decoupled=False, fused=False, state_dtype=torch.float32,
                 decay_exclude=()):
        if fused == "auto":
            raise NotImplementedError(
                "AdamW(fused='auto') picks kernel or plain update through "
                "the runtime autotuner, which is not ported yet "
                "(ROADMAP.md); use fused=True or fused=False")
        if fused not in (True, False):
            raise ValueError(f"fused must be True or False, got {fused!r}")
        if fused and amsgrad:
            raise ValueError("AdamW(fused=True): the fused kernel has no "
                             "amsgrad; use fused=False")
        if fused and state_dtype != torch.float32:
            raise ValueError(f"AdamW(fused=True): the fused kernel keeps "
                             f"f32 moments, got state_dtype={state_dtype}")
        super().__init__(lr)
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.amsgrad = amsgrad
        self.maximize = maximize
        self.decoupled = decoupled
        self.fused = fused
        self.state_dtype = state_dtype
        self.decay_exclude = tuple(decay_exclude)

    def _wd(self, name: str) -> float:
        if any(pat in name for pat in self.decay_exclude):
            return 0.0
        return self.weight_decay

    def init_one(self, name, param):
        if self.fused and param.dtype != torch.float32:
            raise ValueError(f"AdamW(fused=True): {name} is {param.dtype}; "
                             "the fused kernel updates f32 leaves")
        state = {"m": torch.zeros_like(param, dtype=self.state_dtype),
                 "v": torch.zeros_like(param, dtype=self.state_dtype)}
        if self.amsgrad:
            state["vmax"] = torch.zeros_like(param, dtype=self.state_dtype)
        return state

    def update_one(self, name, param, grad, state, step):
        wd = self._wd(name)
        if self.fused:
            adamw_fused.adamw_update_fused(  # looked up per call
                param, grad, state["m"], state["v"], lr=self._lr(step),
                c1=1.0 - math.pow(self.b1, step),
                c2=1.0 - math.pow(self.b2, step), b1=self.b1, b2=self.b2,
                eps=self.eps, wd=wd, decoupled=self.decoupled,
                maximize=self.maximize)
            return
        g = grad.float()
        p = param.float()
        if self.maximize:
            g = -g
        if wd and not self.decoupled:
            g = g + wd * p  # reference adamw.py:37-38
        m = self.b1 * state["m"].float() + (1.0 - self.b1) * g
        v = self.b2 * state["v"].float() + (1.0 - self.b2) * g * g
        mhat = m / (1.0 - math.pow(self.b1, step))
        if self.amsgrad:
            vmax = torch.maximum(state["vmax"].float(), v)
            state["vmax"].copy_(vmax)
            v_for_update = vmax
        else:
            v_for_update = v
        vhat = v_for_update / (1.0 - math.pow(self.b2, step))
        upd = mhat / (torch.sqrt(vhat) + self.eps)
        if wd and self.decoupled:
            upd = upd + wd * p
        state["m"].copy_(m)
        state["v"].copy_(v)
        param.copy_(p - self._lr(step) * upd)
