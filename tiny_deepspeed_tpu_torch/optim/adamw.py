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
is what JAX runs under a schedule.

`fused="auto"` (JAX :144-159) takes the kernel for a leaf that it can
take — a CUDA f32 leaf, no amsgrad, f32 state — and, when a runtime
autotuner is installed (autotuner/), the tuner's per-(shape, dtype) pick
of [`_fused_update` (the kernel), `_plain_update`], with JAX's arguments
(param, grad, m, v, step) and keywords; the tuner times its candidates
on stand-ins it makes, never on a leaf's real moments; a kernel that
fails there raises (`runtime_tuner.hand_kernel`), it is never scored
away.  Any other leaf (the CPU, amsgrad, other state dtypes) takes the
plain update, as JAX's "auto keeps the silent fallback" (:121) — on the
CPU silently, on the card with one warning an optimizer, so that a CUDA
leaf's plain update is never unannounced.
"""

from __future__ import annotations

import math
import warnings

import torch

from ..autotuner import runtime_tuner as _rt
from . import adamw_fused
from .base import Optimizer


class AdamW(Optimizer):
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-2, amsgrad=False, maximize=False,
                 decoupled=False, fused=False, state_dtype=torch.float32,
                 decay_exclude=()):
        if not (fused is True or fused is False or fused == "auto"):
            raise ValueError(
                f"fused must be True, False or 'auto', got {fused!r}")
        if fused is True and amsgrad:
            raise ValueError("AdamW(fused=True): the fused kernel has no "
                             "amsgrad; use fused=False")
        if fused is True and state_dtype != torch.float32:
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
        self._warned_plain = False  # fused="auto" took a CUDA leaf plain
        self.state_dtype = state_dtype
        self.decay_exclude = tuple(decay_exclude)

    def _wd(self, name: str) -> float:
        if any(pat in name for pat in self.decay_exclude):
            return 0.0
        return self.weight_decay

    def init_one(self, name, param):
        if self.fused is True and param.dtype != torch.float32:
            raise ValueError(f"AdamW(fused=True): {name} is {param.dtype}; "
                             "the fused kernel updates f32 leaves")
        state = {"m": torch.zeros_like(param, dtype=self.state_dtype),
                 "v": torch.zeros_like(param, dtype=self.state_dtype)}
        if self.amsgrad:
            state["vmax"] = torch.zeros_like(param, dtype=self.state_dtype)
        return state

    def _use_fused(self, param) -> bool:
        """fused="auto": the kernel can take this leaf (JAX
        `_use_fused`, :82-122, as the port's kernel runs on the card)."""
        return (param.is_cuda and param.dtype == torch.float32
                and not self.amsgrad and self.state_dtype == torch.float32)

    def update_one(self, name, param, grad, state, step):
        kw = dict(lr=self._lr(step), b1=self.b1, b2=self.b2, eps=self.eps,
                  wd=self._wd(name), decoupled=self.decoupled,
                  maximize=self.maximize)
        if self.fused is True:
            _fused_update(param, grad, state["m"], state["v"], step, **kw)
            return
        if self.fused == "auto" and self._use_fused(param):
            impl = _fused_update
            tuner = _rt._default_tuner
            if tuner is not None:
                impl = tuner.choose(
                    _AUTO_CANDIDATES,
                    (param, grad, state["m"], state["v"], step), **kw)
            impl(param, grad, state["m"], state["v"], step, **kw)
            return
        if self.fused == "auto" and param.is_cuda and not self._warned_plain:
            self._warned_plain = True
            warnings.warn(
                f"AdamW(fused='auto'): {name} ({param.dtype}, amsgrad="
                f"{self.amsgrad}, state {self.state_dtype}) and any such "
                "leaf take the plain update: the fused kernel takes f32 "
                "leaves with f32 state and no amsgrad", stacklevel=2)
        _plain_update(param, grad, state["m"], state["v"], step,
                      vmax=state.get("vmax"), **kw)


# -- the update candidates: (param, grad, m, v, step) in place ---------------

def _fused_update(param, grad, m, v, step, *, lr, b1, b2, eps, wd,
                  decoupled, maximize):
    """One launch of the fused kernel (row 13; `adamw_update_fused`,
    looked up per call)."""
    adamw_fused.adamw_update_fused(
        param, grad, m, v, lr=lr, c1=1.0 - math.pow(b1, step),
        c2=1.0 - math.pow(b2, step), b1=b1, b2=b2, eps=eps, wd=wd,
        decoupled=decoupled, maximize=maximize)


def _plain_update(param, grad, m, v, step, *, lr, b1, b2, eps, wd,
                  decoupled, maximize, vmax=None):
    """The plain update, a copy of the JAX `_xla_update` (:202-218) and,
    with `vmax`, of its amsgrad tail (:169-188); math in f32, the state
    written back in its own dtype."""
    g = grad.float()
    p = param.float()
    if maximize:
        g = -g
    if wd and not decoupled:
        g = g + wd * p  # reference adamw.py:37-38
    m_new = b1 * m.float() + (1.0 - b1) * g
    v_new = b2 * v.float() + (1.0 - b2) * g * g
    mhat = m_new / (1.0 - math.pow(b1, step))
    if vmax is not None:
        v_for_update = torch.maximum(vmax.float(), v_new)
        vmax.copy_(v_for_update)
    else:
        v_for_update = v_new
    vhat = v_for_update / (1.0 - math.pow(b2, step))
    upd = mhat / (torch.sqrt(vhat) + eps)
    if wd and decoupled:
        upd = upd + wd * p
    m.copy_(m_new)
    v.copy_(v_new)
    param.copy_(p - lr * upd)


# fused="auto"'s tuner site (JAX :149-159): the kernel first; a kernel
# that fails while timed raises (`hand_kernel`)
_AUTO_CANDIDATES = (_rt.hand_kernel(_fused_update), _plain_update)
