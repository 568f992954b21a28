# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Training engines: single device, DDP, ZeRO-1 and ZeRO-2.

Counterpart of `tiny_deepspeed_tpu/parallel/engine.py` (`ZeroEngine` and
its stage subclasses, :199-1530), the plain lowering only.  One engine
class parameterized by the ZeRO stage: `init(seed) -> TrainState`,
`step(state, batch) -> (state, loss)`, `eval_loss(state, batch)`,
`gather_params`, `gather_opt_state`, `rank_map` and `describe()`.

The step follows the JAX `_step_body` (:1142-1407) exactly:

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
same masks.  Dropout needs one rank (see models/gpt2.py).

Distributed engines (`DDP`, `Zero1`, `Zero2`).  Each rank is a process
of a `torch.distributed` group laid out as the JAX mesh (data, seq)
(parallel/mesh.py).  The numbers are JAX's:

- the loss is the mean over the GLOBAL batch, so the grads are the
  global gradient (JAX :44-49).  `step` takes the global batch, as JAX's
  does, and each rank cuts its block: rows [d*B/D, (d+1)*B/D) and
  columns [s*Tl, (s+1)*Tl) (JAX's batch spec P("data", "seq"), :914).
  The blocks are equal-sized, so the global mean is the average of the
  ranks' own means: each rank differentiates its share, its own mean
  over the world size, and the collectives SUM the shares.  That is
  JAX's per-device partial gradient of the global mean, so a
  dynamic-scale step overflows where JAX's does (a rank's own mean
  would overflow up to world-size times sooner); with a power-of-two
  world the result is the average of the ranks' own gradients bit for
  bit.  The returned loss is the ranks' means averaged (`AVG`);
- with the sequence split (seq_parallel > 1) params are replicated
  across seq and attention runs as ring attention; grads are first
  summed over the seq group, then the stage's collective runs over the
  data group;
- DDP (stage 0) all-reduces the grads over the data group (SUM).  Zero1 does
  the same all-reduce, then each rank updates its own shard of every
  leaf and its optimizer state, and all-gathers the params.  Zero2
  reduce-scatters into the shard instead, so the full gradient does not
  outlive the collective, then updates and all-gathers the same way.
  With `accum_steps` > 1, Zero1 and DDP sum the microbatches locally and
  reduce once; Zero2 reduce-scatters every microbatch into an f32 shard
  accumulator (JAX :1276-1293);
- the shard layout is flat, padded and per leaf (DeepSpeed's): leaf of
  n elements, data size D, shard size S = ceil(n / D); data rank d owns
  elements [d*S, min((d+1)*S, n)).  JAX shards each leaf along an axis
  (`_leaf_spec`, :106-150); AdamW and SGD are elementwise, so the numbers
  are the same.  `gather_opt_state` returns whole leaves to compare;
- `grad_clip`: the global norm's square is the sum of the leaves'
  squares — under Zero2 the shards', all-reduced with SUM over the data
  group;
- `loss_scale="dynamic"`: the finite flag is all-reduced with MIN over
  the world, so every rank skips together;
- init: every rank seeds alike, and rank 0's params are broadcast once
  as a guard;
- on the card the engines need an NCCL process group (gloo would stage
  the card's traffic through the host) and raise otherwise.  The
  collectives are per leaf, after the backward: no overlap with it.

`SingleDevice` is the stage-0 engine without a process group, the JAX
`SingleDevice`.  The update is in place (optim/base.py): the TrainState's
params ARE the model's parameters.  One difference from the JAX engine:
the dynamic scaler's finiteness flag is read on the host (one sync per
step) and the skip is a host branch, where the JAX engine selects on
device.  ZeRO-3 and the JAX engine's telemetry, offload, grad-comm
codecs, buckets, prefetch, hpZ and tensor, expert and pipeline
parallelism are refused with a ValueError (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

from .. import rng as prng
from ..data.loader import rank_block
from ..ops.dispatch import resolve_device
from .mesh import make_context
from .partition import partition_tensors


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
            "hpz": False, "tensor_parallel": 1, "expert_parallel": 1,
            "pipeline_parallel": 1}
_AVG, _SUM, _MIN = dist.ReduceOp.AVG, dist.ReduceOp.SUM, dist.ReduceOp.MIN


def _refuse(name: str, refused: Dict[str, Any], knobs: Dict[str, Any],
            what: str) -> None:
    bad = sorted(set(knobs) - set(refused))
    if bad:
        raise TypeError(f"{name}: unknown argument(s) {bad}")
    on = sorted(k for k, v in knobs.items() if v != refused[k])
    if on:
        raise ValueError(f"{name} {on}: {what} not ported yet (a later "
                         "slice of the port, ROADMAP.md)")


class ZeroEngine:
    """Training engine of one ZeRO stage over the default process group
    (`init_distributed`), or over `pctx` when given."""

    stage: int = 0

    def __init__(self, model, optimizer,
                 device: Union[None, str, torch.device] = None,
                 accum_steps: int = 1, grad_clip: Optional[float] = None,
                 loss_scale=None, loss_scale_growth_interval: int = 2000,
                 seq_parallel: int = 1, seq_impl: str = "ring",
                 pctx=None, **knobs):
        if self.stage >= 3:
            raise ValueError(
                "ZeRO-3 (params sharded at rest, gathered per layer) is not "
                "ported yet: a later slice of the port (ROADMAP.md)")
        _refuse(type(self).__name__, _REFUSED, knobs,
                "telemetry, offload, grad-comm codecs and buckets, "
                "prefetch, hpZ and tensor/expert/pipeline parallelism are")
        self._setup(model, optimizer, device, accum_steps, grad_clip,
                    loss_scale, loss_scale_growth_interval)
        self.pctx = pctx or make_context(seq_parallel, seq_impl)
        if self.device.type == "cuda" and \
                dist.get_backend(self.pctx.data_group) != "nccl":
            raise ValueError(
                f"{type(self).__name__} on the card needs an NCCL process "
                f"group, got {dist.get_backend(self.pctx.data_group)!r}")
        if model.config.dropout and self.pctx.is_multi_device:
            raise ValueError(
                "dropout on more than one rank is not ported yet: the masks "
                "would change with the rank count (ROADMAP.md)")
        self.n_dev = self.pctx.world
        self.n_shard = self.pctx.data_size
        # names in sorted order, as JAX walks them (its param_shapes is a
        # pytree, whose dict keys sort)
        self.rank_map = partition_tensors(
            dict(sorted(model.param_shapes().items())), self.n_shard)
        # flat shard of each leaf: (numel, shard size S, [lo, hi) owned)
        r = self.pctx.data_rank
        self._shards = {}
        for name, shape in model.param_shapes().items():
            n = math.prod(shape)
            s = -(-n // self.n_shard)
            self._shards[name] = (n, s, min(r * s, n), min((r + 1) * s, n))

    def _setup(self, model, optimizer, device, accum_steps, grad_clip,
               loss_scale, loss_scale_growth_interval):
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
        optimizer's zero state (of the rank's shards from stage 1 on).  An
        int seeds a generator on the engine's device.  The dropout base
        key is `fold_in(seed, 0xD0)` (JAX :1042-1049), the seed being the
        generator's initial seed when a generator is given.  Distributed,
        rank 0's params are broadcast once."""
        g = seed_or_generator
        if not isinstance(g, torch.Generator):
            g = torch.Generator(device=self.device).manual_seed(int(g))
        self.model.init(g)
        params = self.model.param_dict()
        if self.pctx is not None:
            with torch.no_grad():
                for p in params.values():
                    dist.broadcast(p.data, src=0,
                                   group=self.pctx.world_group)
        if self.stage >= 1:
            opt_state = self.optimizer.init(
                {n: self._own(n, p.detach()) for n, p in params.items()})
        else:
            opt_state = self.optimizer.init(params)
        scaler = ({"scale": 2.0 ** 15, "good": 0}
                  if self.loss_scale == "dynamic" else None)
        base = (prng.fold_in(g.initial_seed(), 0xD0)
                if self.model.config.dropout else None)
        return TrainState(params=params, opt_state=opt_state,
                          scaler=scaler, dropout_base=base)

    def _own(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's flat shard of a whole leaf (a view)."""
        _, _, lo, hi = self._shards[name]
        return t.reshape(-1)[lo:hi]

    def _gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """Every data rank's shard of `name` -> the whole flat leaf."""
        n, s, lo, hi = self._shards[name]
        buf = shard
        if hi - lo != s:  # the padded tail shard (or an empty one)
            buf = shard.new_zeros(s)
            buf[:hi - lo] = shard
        out = shard.new_empty(s * self.n_shard)
        dist.all_gather_into_tensor(out, buf.contiguous(),
                                    group=self.pctx.data_group)
        return out[:n]

    def _local(self, a) -> torch.Tensor:
        """The rank's block of a global (B, T) or (accum, B, T) batch, as
        a long tensor on the engine's device."""
        t = torch.as_tensor(a, device=self.device).long()
        return t if self.pctx is None else rank_block(t, self.pctx)

    # -- the train step ----------------------------------------------------

    def _loss_and_grads(self, params, idx, targets, scale, rng):
        loss = self.model.apply(idx, targets, rng=rng, pctx=self.pctx)
        if scale is not None:
            loss = loss * scale
        # the rank's share of the global mean (see the module docstring)
        share = loss if self.pctx is None else loss / self.pctx.world
        grads = torch.autograd.grad(share, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def _reduce(self, grads):
        """The stage's gradient collective over the ranks' shares: SUM
        over the seq group, then over the data group — all-reduced
        (stages 0-1) or reduce-scattered into the rank's flat shard
        (stage 2)."""
        pctx = self.pctx
        if pctx is None:
            return grads
        out = {}
        for n, g in grads.items():
            g = g.contiguous()
            if pctx.seq_group is not None:
                dist.all_reduce(g, op=_SUM, group=pctx.seq_group)
            if self.stage < 2:
                dist.all_reduce(g, op=_SUM, group=pctx.data_group)
                out[n] = g
                continue
            numel, s, lo, hi = self._shards[n]
            flat = g.reshape(-1)
            if numel != s * self.n_shard:
                flat = torch.nn.functional.pad(flat,
                                               (0, s * self.n_shard - numel))
            shard = g.new_empty(s)
            dist.reduce_scatter_tensor(shard, flat, op=_SUM,
                                       group=pctx.data_group)
            out[n] = shard[:hi - lo]
        return out

    def step(self, state: TrainState, batch):
        """One optimizer step.  batch = (idx, targets), each (B, T) ints
        (numpy or tensors) — or (accum, B, T) when accum_steps > 1; the
        GLOBAL batch on every rank of a distributed engine.  Returns
        (state, loss) with loss the global batch's mean, a 0-d f32 tensor
        on the device."""
        idx, targets = (self._local(a) for a in batch)
        params = state.params
        dynamic = self.loss_scale == "dynamic"
        scale = (state.scaler["scale"] if dynamic
                 else (float(self.loss_scale) if self.loss_scale else None))
        rng = (prng.fold_in(state.dropout_base, state.opt_state["step"])
               if state.dropout_base is not None else None)
        sharded_grads = self.stage >= 2 and self.pctx is not None

        if self.accum_steps == 1:
            loss, grads = self._loss_and_grads(params, idx, targets, scale,
                                               rng)
            grads = self._reduce(grads)
        else:
            if idx.dim() != 3 or idx.shape[0] != self.accum_steps:
                raise ValueError(
                    f"accum_steps={self.accum_steps}: batch must be "
                    f"(accum, B, T), got {tuple(idx.shape)}")
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            acc = {}
            for i in range(self.accum_steps):
                l, g = self._loss_and_grads(
                    params, idx[i], targets[i], scale,
                    None if rng is None else prng.fold_in(rng, i))
                if sharded_grads:  # every microbatch into the f32 shard
                    g = self._reduce(g)
                loss = loss + l
                for n in params:
                    acc[n] = (g[n].float() if i == 0
                              else acc[n] + g[n].float())
            loss = loss / self.accum_steps
            grads = {n: (acc[n] / self.accum_steps).to(p.dtype)
                     for n, p in params.items()}
            if not sharded_grads:  # summed locally, reduced once
                grads = self._reduce(grads)
        if self.pctx is not None:
            dist.all_reduce(loss, op=_AVG, group=self.pctx.world_group)

        if scale is not None:
            loss = loss / scale
            inv = 1.0 / scale
            grads = {n: (g.float() * inv).to(g.dtype)
                     for n, g in grads.items()}
        finite = True
        if dynamic:
            # judged on the UNSCALED grads, before clipping
            flags = torch.stack([torch.isfinite(g).all()
                                 for g in grads.values()]).all()
            if self.pctx is not None:
                flags = flags.to(torch.int32)
                dist.all_reduce(flags, op=_MIN, group=self.pctx.world_group)
            finite = bool(flags)
        if self.grad_clip is not None:
            gsq = torch.stack([g.float().square().sum()
                               for g in grads.values()]).sum()
            if sharded_grads:
                dist.all_reduce(gsq, op=_SUM, group=self.pctx.data_group)
            factor = torch.clamp(self.grad_clip / (gsq.sqrt() + 1e-6),
                                 max=1.0)
            grads = {n: (g.float() * factor).to(g.dtype)
                     for n, g in grads.items()}

        if finite:
            if self.stage >= 1:
                self._update_shards(params, grads, state.opt_state)
            else:
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
    def _update_shards(self, params, grads, opt_state):
        """ZeRO-1/2: each rank updates its flat shard of every leaf and
        the shard's optimizer state (the optimizer's per-leaf
        `update_one`, in place), then all-gathers the leaf."""
        step = opt_state["step"] + 1
        for n, p in params.items():
            flat = p.detach().reshape(-1)
            own = self._own(n, flat)
            g = grads[n] if self.stage >= 2 else self._own(n, grads[n])
            if own.numel():
                self.optimizer.update_one(n, own, g,
                                          opt_state["state"][n], step)
            flat.copy_(self._gather(n, own))
        opt_state["step"] = step

    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch) -> torch.Tensor:
        """Mean loss on one global (B, T) batch — forward only, no state
        change."""
        idx, targets = (self._local(a) for a in batch)
        loss = self.model.apply(idx, targets, pctx=self.pctx)
        if self.pctx is not None:
            dist.all_reduce(loss, op=_AVG, group=self.pctx.world_group)
        return loss

    # -- whole-state views and reporting -----------------------------------

    def gather_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """A copy of the whole params (replicated in stages 0-2)."""
        return {n: p.detach().clone() for n, p in state.params.items()}

    @torch.no_grad()
    def gather_opt_state(self, state: TrainState) -> Dict[str, Any]:
        """The optimizer state with whole leaves (all-gathered from the
        data ranks' shards from stage 1 on), to compare with JAX's."""
        opt = state.opt_state
        if self.stage == 0:
            return {"step": opt["step"],
                    "state": {n: {k: t.clone() for k, t in slots.items()}
                              for n, slots in opt["state"].items()}}
        shapes = self.model.param_shapes()
        return {"step": opt["step"],
                "state": {n: {k: self._gather(n, t).reshape(shapes[n])
                              for k, t in slots.items()}
                          for n, slots in opt["state"].items()}}

    def describe(self) -> str:
        extras = ""
        if self.grad_clip is not None:
            extras += f", grad_clip={self.grad_clip}"
        if self.loss_scale is not None:
            extras += f", loss_scale={self.loss_scale}"
        return (f"{type(self).__name__}(stage={self.stage}, "
                f"devices={self.n_dev}, accum={self.accum_steps}, params "
                f"sharded=False, grads sharded={self.stage >= 2}, opt state "
                f"sharded={self.stage >= 1}{extras})")


class SingleDevice(ZeroEngine):
    """Stage-0 training on one device (the card unless `device="cpu"`),
    with no process group."""

    stage = 0

    def __init__(self, model, optimizer,
                 device: Union[None, str, torch.device] = None,
                 accum_steps: int = 1, grad_clip: Optional[float] = None,
                 loss_scale=None, loss_scale_growth_interval: int = 2000,
                 **knobs):
        _refuse("SingleDevice", dict(_REFUSED, seq_parallel=1), knobs,
                "multi-device, telemetry and offload knobs are")
        self._setup(model, optimizer, device, accum_steps, grad_clip,
                    loss_scale, loss_scale_growth_interval)
        self.pctx = None

    def describe(self) -> str:
        return (f"SingleDevice(device={self.device}, "
                f"accum={self.accum_steps}, grad_clip={self.grad_clip}, "
                f"loss_scale={self.loss_scale})")


class DDP(ZeroEngine):
    """Replicated params and optimizer state, grads all-reduced."""
    stage = 0


class Zero1(ZeroEngine):
    """+ optimizer state sharded: each rank updates its shard, params
    all-gathered."""
    stage = 1


class Zero2(ZeroEngine):
    """+ gradients sharded: reduce-scattered into the rank's shard."""
    stage = 2


class Zero3(ZeroEngine):
    """+ params sharded at rest: not ported yet, raises (ROADMAP.md)."""
    stage = 3
