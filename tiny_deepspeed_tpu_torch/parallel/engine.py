# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The single-device training engine.

Counterpart of `tiny_deepspeed_tpu/parallel/engine.py::SingleDevice` (a
stage-0 `ZeroEngine` on one device): `init(seed) -> TrainState`,
`step(state, batch) -> (state, loss)`, `eval_loss(state, batch)`.  The
step follows the JAX `_step_body` (:1142-1407) exactly:

1. the loss, scaled INSIDE the differentiated function when loss scaling
   is on, so the whole backward runs on scaled values;
2. with `accum_steps` > 1, batch is (accum, B, T): grads summed in f32
   over the microbatches and the mean taken (loss likewise);
3. loss and grads unscaled;
4. with dynamic scaling, finiteness judged on the UNSCALED grads, before
   clipping can turn an inf norm into NaNs;
5. global-L2-norm clipping: grads * min(1, clip / (norm + 1e-6));
6. the optimizer update — skipped entirely on a non-finite dynamic-scale
   step (params, moments and the step counter stay), which halves the
   scale; `loss_scale_growth_interval` clean steps in a row double it.

With dropout on (model.config.dropout > 0), step `n` draws its masks
from the key `fold_in(state.dropout_base, n)` (n = the optimizer's step
counter before the update) and microbatch `i` from `fold_in(that, i)`,
as the JAX step does (:1153-1156, :1265); `eval_loss` drops nothing.  A
skipped dynamic-scale step leaves the counter, so its retry redraws the
same masks.

The update is in place (optim/base.py): the TrainState's params ARE the
model's parameters.  One difference from the JAX engine: the dynamic
scaler's finiteness flag is read on the host (one sync per step) and the
skip is a host branch, where the JAX engine selects on device.

Everything that needs more than one device, or the JAX engine's telemetry
and offload machinery, is refused with a ValueError; the distributed
engines are a later slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from .. import rng as prng
from ..ops.dispatch import resolve_device


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    # dynamic loss-scale state {"scale": float, "good": int} when the
    # engine runs with loss_scale="dynamic"; None otherwise
    scaler: Optional[Dict[str, Any]] = None
    # the dropout mask stream's base key (derived from the init seed)
    # when the model has dropout > 0; None otherwise (JAX :86-92)
    dropout_base: Optional[int] = None


# knobs of the JAX engine the port refuses, with their off values
_REFUSED = {"telemetry": None, "offload_opt_state": False,
            "grad_comm": "fp32", "grad_buckets": 1, "gather_prefetch": 0,
            "hpz": False, "seq_parallel": 1, "tensor_parallel": 1,
            "expert_parallel": 1, "pipeline_parallel": 1}


class SingleDevice:
    """Stage-0 training on one device (the card unless `device="cpu"`)."""

    def __init__(self, model, optimizer,
                 device: Union[None, str, torch.device] = None,
                 accum_steps: int = 1, grad_clip: Optional[float] = None,
                 loss_scale=None, loss_scale_growth_interval: int = 2000,
                 **knobs):
        bad = sorted(set(knobs) - set(_REFUSED))
        if bad:
            raise TypeError(f"SingleDevice: unknown argument(s) {bad}")
        on = sorted(k for k, v in knobs.items() if v != _REFUSED[k])
        if on:
            raise ValueError(
                f"SingleDevice {on}: multi-device, telemetry and offload "
                "knobs are not ported yet (the distributed engines are a "
                "later slice of the port, ROADMAP.md)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if not (loss_scale is None or loss_scale == "dynamic"
                or (isinstance(loss_scale, (int, float)) and loss_scale > 0)):
            raise ValueError(f"loss_scale must be None, a positive number "
                             f"or 'dynamic', got {loss_scale!r}")
        self.model = model
        self.optimizer = optimizer
        self.accum_steps = accum_steps
        self.grad_clip = grad_clip
        self.loss_scale = loss_scale
        self.loss_scale_growth_interval = loss_scale_growth_interval

    # -- state -------------------------------------------------------------

    def init(self, seed_or_generator: Union[int, torch.Generator]
             ) -> TrainState:
        """Seeded GPT-2 init of the model's parameters (in place) and the
        optimizer's zero state.  An int seeds a generator on the engine's
        device.  The dropout base key is `fold_in(seed, 0xD0)` (JAX
        :1042-1049), the seed being the generator's initial seed when a
        generator is given."""
        g = seed_or_generator
        if not isinstance(g, torch.Generator):
            g = torch.Generator(device=self.device).manual_seed(int(g))
        self.model.init(g)
        params = self.model.param_dict()
        scaler = ({"scale": 2.0 ** 15, "good": 0}
                  if self.loss_scale == "dynamic" else None)
        base = (prng.fold_in(g.initial_seed(), 0xD0)
                if self.model.config.dropout else None)
        return TrainState(params=params,
                          opt_state=self.optimizer.init(params),
                          scaler=scaler, dropout_base=base)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).long()

    # -- the train step ----------------------------------------------------

    def _loss_and_grads(self, params, idx, targets, scale, rng):
        loss = self.model.apply(idx, targets, rng=rng)
        if scale is not None:
            loss = loss * scale
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def step(self, state: TrainState, batch):
        """One optimizer step.  batch = (idx, targets), each (B, T) ints
        (numpy or tensors) — or (accum, B, T) when accum_steps > 1.
        Returns (state, loss) with loss a 0-d f32 tensor on the device."""
        idx, targets = (self._tensor(a) for a in batch)
        params = state.params
        dynamic = self.loss_scale == "dynamic"
        scale = (state.scaler["scale"] if dynamic
                 else (float(self.loss_scale) if self.loss_scale else None))
        rng = (prng.fold_in(state.dropout_base, state.opt_state["step"])
               if state.dropout_base is not None else None)

        if self.accum_steps == 1:
            loss, grads = self._loss_and_grads(params, idx, targets, scale,
                                               rng)
        else:
            if idx.dim() != 3 or idx.shape[0] != self.accum_steps:
                raise ValueError(
                    f"accum_steps={self.accum_steps}: batch must be "
                    f"(accum, B, T), got {tuple(idx.shape)}")
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            for i in range(self.accum_steps):
                l, g = self._loss_and_grads(
                    params, idx[i], targets[i], scale,
                    None if rng is None else prng.fold_in(rng, i))
                loss = loss + l
                for n in acc:
                    acc[n] += g[n].float()
            loss = loss / self.accum_steps
            grads = {n: (acc[n] / self.accum_steps).to(p.dtype)
                     for n, p in params.items()}

        if scale is not None:
            loss = loss / scale
            inv = 1.0 / scale
            grads = {n: (g.float() * inv).to(g.dtype)
                     for n, g in grads.items()}
        finite = True
        if dynamic:
            # judged on the UNSCALED grads, before clipping
            flags = torch.stack([torch.isfinite(g).all()
                                 for g in grads.values()])
            finite = bool(flags.all())
        if self.grad_clip is not None:
            gsq = torch.stack([g.float().square().sum()
                               for g in grads.values()]).sum()
            factor = torch.clamp(self.grad_clip / (gsq.sqrt() + 1e-6),
                                 max=1.0)
            grads = {n: (g.float() * factor).to(g.dtype)
                     for n, g in grads.items()}

        if finite:
            self.optimizer.update(params, grads, state.opt_state)
        if dynamic:
            # overflow -> the whole update was skipped (params, moments
            # and the step counter); halve the scale.  Grow it after
            # `loss_scale_growth_interval` clean steps in a row.
            good = state.scaler["good"] + 1
            grow = good >= self.loss_scale_growth_interval
            if finite:
                state.scaler = {"scale": scale * 2.0 if grow else scale,
                                "good": 0 if grow else good}
            else:
                state.scaler = {"scale": max(scale * 0.5, 1.0), "good": 0}
        return state, loss

    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch) -> torch.Tensor:
        """Mean loss on one (B, T) batch — forward only, no state change."""
        idx, targets = (self._tensor(a) for a in batch)
        return self.model.apply(idx, targets)

    def describe(self) -> str:
        return (f"SingleDevice(device={self.device}, "
                f"accum={self.accum_steps}, grad_clip={self.grad_clip}, "
                f"loss_scale={self.loss_scale})")
