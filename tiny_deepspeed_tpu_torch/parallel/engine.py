# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Training engines: single device, DDP, ZeRO-1, ZeRO-2 and ZeRO-3.

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
same masks.  On more than one rank each rank draws its block of the
global batch's masks (models/gpt2.py `_dropout_frame`), so a run's
masks do not depend on the rank layout: every engine at any data and
seq split drops what SingleDevice drops on the same global batch.  The
schedule's explicit grad lowerings ("quant_mono", "bucket", "composed")
run the model as on one device on each rank's own batch, and draw
rank-local masks as JAX's do (JAX schedule.py:1337-1343, :1476-1481,
:1813-1819): the step's key folded with the data rank, then under
accumulation with the microbatch index; the model splits it into the
embedding's and the layers' keys as on one device.

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
  across seq and attention runs as ring attention or, with
  `seq_impl="ulysses"`, as Ulysses (parallel/ulysses.py; it needs the
  head count divisible by the seq size, JAX's check and message); grads
  are first summed over the seq group, then the stage's collective runs
  over the data group.  `seq_impl` changes no state layout: a
  checkpoint taken under the ring resumes under Ulysses;
- DDP (stage 0) all-reduces the grads over the data group (SUM).  Zero1 does
  the same all-reduce, then each rank updates its own shard of every
  leaf and its optimizer state, and all-gathers the params.  Zero2
  reduce-scatters into the shard instead, so the full gradient does not
  outlive the collective, then updates and all-gathers the same way.
  Zero3 keeps the params sharded at rest too (parallel/zero3.py): the
  forward gathers them — the non-block leaves once per step, each
  layer's block weights inside its checkpoint — the backward
  reduce-scatters their gradients straight into the shards, and the
  update writes the shards with no all-gather.
  With `accum_steps` > 1, Zero1 and DDP sum the microbatches locally and
  reduce once; Zero2 and Zero3 reduce-scatter every microbatch into an
  f32 shard accumulator (JAX :1276-1293);
- the shard layout is flat, padded and per leaf (DeepSpeed's): leaf of
  n elements, data size D, shard size S = ceil(n / D); data rank d owns
  elements [d*S, min((d+1)*S, n)).  JAX shards each leaf along an axis
  (`_leaf_spec`, :106-150); AdamW and SGD are elementwise, so the numbers
  are the same.  `gather_opt_state` returns whole leaves to compare;
- `grad_clip`: the global norm's square is the sum of the leaves'
  squares — under Zero2 and Zero3 the shards', all-reduced with SUM over
  the data group;
- `loss_scale="dynamic"`: the finite flag is all-reduced with MIN over
  the world, so every rank skips together;
- init: every rank seeds alike, and rank 0's params are broadcast once
  as a guard;
- on the card the engines need an NCCL process group (gloo would stage
  the card's traffic through the host) and raise otherwise.  Without a
  schedule the collectives are per leaf, after the backward: no overlap
  with it.

The in-step collective schedule (parallel/schedule.py; JAX :581-716).
`grad_buckets`, `gather_prefetch`, `gather_groups` and `hpz` (with
`hpz_granule_of`) become slot declarations; one `build_schedule` at
construction validates them and picks JAX's lowering, which `describe()`
names and `step` follows:

- "plain": the step above (also every knob on a 1-rank data axis, with
  JAX's inert warning);
- "prefetch": the same step, the model's layer loop replaced by the
  prefetching executor (its numbers are the on-demand gather's);
- "bucket" (stages 0-2): each rank differentiates its own batch's mean
  and the buckets' collectives run from inside the backward; the tail is
  released after it, in the compute dtype; the earlier microbatches of
  an accumulated step are summed locally and folded into the last one's
  releases (JAX `bucketed_step`);
- "composed": the executor of JAX's `composed_step` — own-batch means,
  releases per bucket (or per layer) as means over the data group, the
  ZeRO-3 tail through its gather's reduce-scatter times 1/(scale * D).
  No accumulation (JAX refuses it there too).

The grad-comm codecs (parallel/comm.py; JAX :582-624).  `grad_comm`
int8 or fp8 (or "auto") sends every gradient release through the
error-fed blockwise codec, `grad_comm_block` elements a scale,
`grad_comm_groups` the 2-hop schedule's inner size (intra and inter
process groups made once, on every rank in one order);
`grad_comm_error_feedback` keeps the residual, the rank's row of
`Schedule.residual_len` f32 zeros at init in `TrainState.grad_residual`;
`grad_comm_tail` quantizes composed ZeRO-3's non-block tail too;
`hpz_comm` moves hpZ's replica rebuild through the codec.  Without
buckets at stages 0-2 the lowering is "quant_mono" (JAX
`monolithic_quant_step`): each rank differentiates its own batch with
the model run as on one device (`pctx=None`: an MoE routes within the
rank's shard, as JAX's replay does), accumulated microbatches summed
locally, unscaled, then one sync.  A step the dynamic scaler skips
rolls the residual back with the rest of the state.

Telemetry (JAX :290-311, :1158-1213, :1393-1421).  `telemetry=` a
`telemetry.Telemetry` (or any object with `on_step_output(aux)`): the
engine calls its `attach(self)` at construction, and every step pushes
the (5,) health vector (telemetry/health.py: loss, grad / update /
param global norms, non-finite grad count) into `on_step_output`
WITHOUT syncing.  The norms run over the clipped gradients and the
params after the update; the update runs in place, so its norm is
summed leaf by leaf as the optimizer writes.  Under ZeRO-1/2/3 each
rank sums the pieces it owns and one all-reduce of the packed partial
sums over the data group makes them global.  A `Telemetry(layers=True)`
also declares the schedule's probe slot: a zero (n_layer, 4) probe is
differentiated with the params (the "probe" lowering's `ProbeScan`, or
inside "composed" the executor's recompute), its gradient summed raw
over microbatches and over the ranks, and the (n_layer, 6) layer-health
matrix is pushed with the vector.  With `telemetry=None` the step runs
exactly the code it runs without the knob.

Optimizer-state offload (JAX :424-440, :843-875, :1070-1131).
`offload_opt_state=True` keeps every per-leaf optimizer slot in host
memory (pinned on the card; parallel/offload.py) and streams the slots
through the device one leaf at a time for the update, at most
`offload_prefetch` leaves in flight: stage 0 and ZeRO-1/2's owned flat
shards and ZeRO-3's shards alike.  The step counter stays put; a skipped
dynamic-scale step streams nothing.  The numbers are bit for bit the
unoffloaded engine's.  An optimizer that overrides `update()` is
refused, as JAX refuses it (the stream calls `update_one`).

The explicit lowerings ("quant_mono", "bucket", "composed") unscale
before their collectives, so the engine does not unscale again;
`_reduce` is skipped for what they released.  On the card they need
world > 1 to differ from the plain step, so at world 1 they are driven
by building the executors directly (chip_smoke.py phases 12 and 13).

`SingleDevice` is the stage-0 engine without a process group, the JAX
`SingleDevice`.  The update is in place (optim/base.py): the TrainState's
params ARE the model's parameters.  One difference from the JAX engine:
the dynamic scaler's finiteness flag is read on the host (one sync per
step) and the skip is a host branch, where the JAX engine selects on
device.  The JAX engine's tensor, expert and pipeline parallelism are
refused with a ValueError (ROADMAP.md).
`evenness_priority` shapes `rank_map` only, with JAX's warning.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

from .. import rng as prng
from ..data.loader import rank_block
from ..ops.dispatch import resolve_device
from ..optim.base import Optimizer
from ..telemetry import health as H
from . import schedule as sched
from .comm import GRAD_COMM_MODES, _hier_groups, new_groups
from .mesh import granule_map, make_context
from .offload import MomentStream
from .partition import partition_tensors
from .zero3 import LayerGather, Zero3Gather, gather_flat, scatter_flat


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
    # the engine and rank that hold this state (`ZeroEngine.layout`):
    # what a checkpoint records and a load checks (utils/checkpoint.py)
    layout: Optional[Dict[str, Any]] = None
    # the grad-comm codec's error-feedback residual: this rank's row of
    # Schedule.residual_len f32 (JAX :97); None without one
    grad_residual: Optional[torch.Tensor] = None


# knobs of the JAX engine the port refuses, with their off values
_REFUSED = {"tensor_parallel": 1, "expert_parallel": 1,
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


def _sched_knobs(grad_buckets, gather_prefetch, gather_groups, hpz,
                 grad_comm="fp32", grad_comm_groups=None,
                 grad_comm_block=256, grad_comm_error_feedback=True,
                 grad_comm_tail="fp32", hpz_comm="fp32") -> Dict[str, Any]:
    """The schedule and codec knobs checked as the JAX engine checks them
    (:582-649) before its schedule is built; build_schedule's keyword
    arguments."""
    if grad_comm not in GRAD_COMM_MODES and grad_comm != "auto":
        raise ValueError(f"grad_comm must be one of {GRAD_COMM_MODES} or "
                         f"'auto', got {grad_comm!r}")
    grad_comm_groups = int(grad_comm_groups) if grad_comm_groups else None
    if grad_comm == "fp32" and grad_comm_groups:
        raise ValueError("grad_comm_groups requires grad_comm='int8' or "
                         "'fp8' (grad_comm='fp32' runs no quantized "
                         "schedule)")
    if grad_buckets != "auto":
        grad_buckets = int(grad_buckets) if grad_buckets else 1
        if grad_buckets < 1:
            raise ValueError(f"grad_buckets must be >= 1, got "
                             f"{grad_buckets}")
    if grad_comm_tail not in GRAD_COMM_MODES:
        raise ValueError(f"grad_comm_tail must be one of {GRAD_COMM_MODES}, "
                         f"got {grad_comm_tail!r}")
    gather_prefetch = int(gather_prefetch) if gather_prefetch else 0
    if gather_prefetch < 0:
        raise ValueError(
            f"gather_prefetch must be >= 0 (0/1 = the on-demand gather; "
            f"K >= 2 holds K layers), got {gather_prefetch}")
    if gather_groups != "auto":
        gather_groups = int(gather_groups) if gather_groups else None
        if gather_groups and gather_prefetch <= 1:
            raise ValueError("gather_groups requires gather_prefetch >= 2 "
                             "(the 2-hop gather lives in the explicit "
                             "prefetched schedule)")
    if hpz_comm not in GRAD_COMM_MODES:
        raise ValueError(f"hpz_comm must be one of {GRAD_COMM_MODES}, "
                         f"got {hpz_comm!r}")
    return dict(grad_buckets=grad_buckets, gather_prefetch=gather_prefetch,
                gather_groups=gather_groups, hpz=bool(hpz),
                grad_comm=grad_comm, grad_comm_groups=grad_comm_groups,
                grad_comm_block=int(grad_comm_block),
                grad_comm_error_feedback=bool(grad_comm_error_feedback),
                grad_comm_tail=grad_comm_tail, hpz_comm=hpz_comm)


def _check_ulysses(model, pctx) -> None:
    """JAX's check (engine.py:542-552): Ulysses splits the heads over the
    seq group, so with a seq split the head count must divide by it."""
    if pctx.seq_impl != "ulysses" or pctx.seq_size == 1:
        return
    nh, sp = model.config.n_head, pctx.seq_size
    if nh % sp:
        raise ValueError(
            f"seq_impl='ulysses' needs local heads (n_head {nh} / tp 1) "
            f"divisible by the seq axis size {sp} — use seq_impl='ring' "
            "instead")


class ZeroEngine:
    """Training engine of one ZeRO stage over the default process group
    (`init_distributed`), or over `pctx` when given."""

    stage: int = 0

    def __init__(self, model, optimizer,
                 device: Union[None, str, torch.device] = None,
                 accum_steps: int = 1, grad_clip: Optional[float] = None,
                 loss_scale=None, loss_scale_growth_interval: int = 2000,
                 seq_parallel: int = 1, seq_impl: str = "ring",
                 pctx=None, grad_buckets=1, gather_prefetch: int = 0,
                 gather_groups=None, hpz: bool = False,
                 hpz_granule_of: Optional[Dict[int, int]] = None,
                 grad_comm: str = "fp32",
                 grad_comm_groups: Optional[int] = None,
                 grad_comm_block: int = 256,
                 grad_comm_error_feedback: bool = True,
                 grad_comm_tail: str = "fp32", hpz_comm: str = "fp32",
                 evenness_priority: float = 0.0,
                 offload_opt_state: bool = False, offload_prefetch: int = 2,
                 telemetry=None, **knobs):
        _refuse(type(self).__name__, _REFUSED, knobs,
                "tensor/expert/pipeline parallelism are")
        knob = _sched_knobs(grad_buckets, gather_prefetch, gather_groups,
                            hpz, grad_comm, grad_comm_groups,
                            grad_comm_block, grad_comm_error_feedback,
                            grad_comm_tail, hpz_comm)
        self._setup(model, optimizer, device, accum_steps, grad_clip,
                    loss_scale, loss_scale_growth_interval,
                    offload_opt_state, offload_prefetch, telemetry)
        self.pctx = pctx or make_context(seq_parallel, seq_impl)
        if self.device.type == "cuda" and \
                dist.get_backend(self.pctx.data_group) != "nccl":
            raise ValueError(
                f"{type(self).__name__} on the card needs an NCCL process "
                f"group, got {dist.get_backend(self.pctx.data_group)!r}")
        _check_ulysses(model, self.pctx)
        self.n_dev = self.pctx.world
        self.n_shard = self.pctx.data_size
        self._build_schedule(knob, hpz_granule_of)
        self._rank_map(evenness_priority)
        # flat shard of each leaf: (numel, shard size S, [lo, hi) owned)
        r = self.pctx.data_rank
        self._shards = {}
        for name, shape in model.param_shapes().items():
            n = math.prod(shape)
            s = -(-n // self.n_shard)
            self._shards[name] = (n, s, min(r * s, n), min((r + 1) * s, n))
        if self.stage < 3:  # Zero3 builds its executor over its gather
            self._exec = self._make_executor()

    def _rank_map(self, evenness_priority: float) -> None:
        """`rank_map`: names in sorted order, as JAX walks them (its
        param_shapes is a pytree, whose dict keys sort)."""
        self.rank_map = partition_tensors(
            dict(sorted(self.model.param_shapes().items())), self.n_shard,
            evenness_priority)
        if evenness_priority:
            warnings.warn(
                "evenness_priority shapes only engine.rank_map (the "
                "reference-parity ownership report); the physical layout "
                "is always even axis-sharding.  For the reference's "
                "whole-tensor placement semantics use partition_tensors + "
                "materialize_owned directly (parallel/partition.py).",
                stacklevel=3)

    def _build_schedule(self, knob, granule_of) -> None:
        """One `build_schedule` over the knobs (JAX :670-703); the hpZ /
        "auto" granule map is the hosts' (`mesh.granule_map`) unless
        `hpz_granule_of` overrides it.  Then the grad slot's codecs (the
        2-hop groups made here, on every rank in one order)."""
        pctx = self.pctx
        if granule_of is None and pctx is not None:
            def granule_of():
                return granule_map(pctx)
        busy = ["seq"] if pctx is not None and pctx.seq_size > 1 else []
        self._schedule = sched.build_schedule(
            model=self.model, stage=self.stage, n_shard=self.n_shard,
            busy_axes=busy, accum_steps=self.accum_steps,
            granule_of=granule_of, telemetry_layers=self._layers_on,
            **knob)
        self._lowering = self._schedule.lowering
        self._exec = None
        self._codec = self._tail_codec = None
        g = self._schedule.grad
        if g is not None and (g.mode != "fp32" or g.tail_mode != "fp32"):
            hops = None
            if g.groups:
                intra, inter = _hier_groups(self.n_shard, g.groups)
                hops = (self._data_groups(intra), self._data_groups(inter))
            kw = dict(group=pctx.data_group, n=self.n_shard,
                      rank=pctx.data_rank, block=g.block, inner=g.groups,
                      hops=hops)
            if g.mode != "fp32":
                self._codec = sched.Codec(mode=g.mode, **kw)
            if g.tail_mode != "fp32":
                self._tail_codec = sched.Codec(mode=g.tail_mode, **kw)

    def _setup(self, model, optimizer, device, accum_steps, grad_clip,
               loss_scale, loss_scale_growth_interval, offload_opt_state,
               offload_prefetch, telemetry):
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
        # JAX :846-865: the window is validated whether or not offload is
        # on; 1 streams the leaves one after another
        self.offload_opt_state = bool(offload_opt_state)
        self.offload_prefetch = int(offload_prefetch)
        if self.offload_prefetch < 1:
            raise ValueError(
                f"offload_prefetch must be >= 1 (1 = serial streaming, "
                f"no double buffer; default 2), got {offload_prefetch}")
        self._offload = None
        if self.offload_opt_state:
            if type(optimizer).update is not Optimizer.update:
                raise ValueError(
                    f"offload_opt_state streams moments via the per-leaf "
                    f"update_one contract, but {type(optimizer).__name__} "
                    f"overrides update(); offload is unsupported for it")
            self._offload = MomentStream(self.offload_prefetch, self.device)
        # the telemetry settles before the schedule is built: layers mode
        # declares the probe slot (JAX :655-662)
        self.telemetry = telemetry
        self._telemetry_on = telemetry is not None
        if self._telemetry_on and hasattr(telemetry, "attach"):
            telemetry.attach(self)
        self._layers_on = bool(self._telemetry_on
                               and getattr(telemetry, "layers", False))

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
        if self.stage >= 3:
            params = self._shard_model(params)
            opt_state = self._init_opt(
                {n: p.detach() for n, p in params.items()})
        elif self.stage >= 1:
            opt_state = self._init_opt(
                {n: self._own(n, p.detach()) for n, p in params.items()})
        else:
            opt_state = self._init_opt(params)
        scaler = ({"scale": 2.0 ** 15, "good": 0}
                  if self.loss_scale == "dynamic" else None)
        base = (prng.fold_in(g.initial_seed(), 0xD0)
                if self.model.config.dropout else None)
        return TrainState(params=params, opt_state=opt_state,
                          scaler=scaler, dropout_base=base,
                          layout=self.layout(),
                          grad_residual=self.zero_residual())

    def _init_opt(self, slots) -> Dict[str, Any]:
        """The optimizer's zero state of `slots`; under offload built as
        `Optimizer.init` builds it, each leaf's slots moved to host memory
        as they are made (never the whole moments on the device)."""
        if self._offload is None:
            return self.optimizer.init(slots)
        return {"step": 0, "state": {
            n: self._offload.host_slots(self.optimizer.init_one(n, p))
            for n, p in slots.items()}}

    def zero_residual(self) -> Optional[torch.Tensor]:
        """This rank's error-feedback residual row at init: residual_len
        f32 zeros (JAX :1051-1057), or None without one."""
        n = self._schedule.residual_len
        if not n:
            return None
        return torch.zeros(n, dtype=torch.float32, device=self.device)

    # -- the layout a checkpoint records -----------------------------------

    def layout(self) -> Dict[str, Any]:
        """This engine and rank: the engine's name and ZeRO stage, the
        world, data and seq sizes, the rank's coordinates and the model's
        whole param shapes.  Two states share a shard layout iff engine,
        stage and sizes agree."""
        p = self.pctx
        return {"engine": type(self).__name__, "stage": self.stage,
                "shapes": {n: list(s) for n, s in
                           self.model.param_shapes().items()},
                "world": 1 if p is None else p.world,
                "data_size": 1 if p is None else p.data_size,
                "seq_size": 1 if p is None else p.seq_size,
                "rank": 0 if p is None else p.rank,
                "data_rank": 0 if p is None else p.data_rank,
                "seq_rank": 0 if p is None else p.seq_rank}

    def state_target(self):
        """The rank's TrainState tensors as `init` would build them, on
        the meta device (no memory, no init drawn): (params, opt_state),
        each leaf the shape and dtype the rank holds — whole leaves, or
        ZeRO-3's shards; the optimizer's slots of whole leaves (stage 0),
        of the rank's flat shard (stages 1-2) or of its ZeRO-3 shard."""
        whole = {n: torch.empty(s, dtype=self.model.config.param_dtype,
                                device="meta")
                 for n, s in self.model.param_shapes().items()}
        if self.stage >= 3:
            params = {n: self._z3.shard(n, t) for n, t in whole.items()}
            slots = params
        elif self.stage >= 1:
            params = whole
            slots = {n: self._own(n, t) for n, t in whole.items()}
        else:
            params = slots = whole
        return params, self.optimizer.init(slots)

    @torch.no_grad()
    def restore(self, params, opt_state, scaler=None,
                dropout_base=None, grad_residual=None) -> TrainState:
        """A TrainState from a checkpoint's tensors (this rank's, checked
        against `state_target`, on the engine's device), in place of
        `init`: the params are copied into the model's own parameters
        (ZeRO-3 takes them as its shards).  Without a saved residual an
        engine that keeps one starts from zeros (JAX
        utils/checkpoint.py:277-290).  Under offload the moments go back
        to host memory."""
        state_params = self.model.param_dict()
        for n, p in state_params.items():
            p.copy_(params[n])
        opt_state = self._rest_opt(opt_state)
        return TrainState(params=state_params, opt_state=opt_state,
                          scaler=scaler, dropout_base=dropout_base,
                          layout=self.layout(),
                          grad_residual=self._residual_of(grad_residual))

    def _rest_opt(self, opt_state) -> Dict[str, Any]:
        """A restored optimizer state where it rests: its slots in host
        memory under offload, as they are otherwise."""
        if self._offload is None:
            return opt_state
        return dict(opt_state,
                    state=self._offload.host_state(opt_state["state"]))

    def _residual_of(self, saved) -> Optional[torch.Tensor]:
        """A checkpoint's residual row if it fits this engine's, else the
        zeros `init` makes (None when the engine keeps none)."""
        zero = self.zero_residual()
        if zero is None or saved is None or saved.shape != zero.shape:
            return zero
        return saved.to(zero.device, torch.float32).clone()

    def _own(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's flat shard of a whole leaf (a view)."""
        _, _, lo, hi = self._shards[name]
        return t.reshape(-1)[lo:hi]

    def _gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """Every data rank's shard of `name` -> the whole flat leaf."""
        n, s, _, _ = self._shards[name]
        return gather_flat(shard, n, s, self.pctx.data_group, self.n_shard)

    def _local(self, a) -> torch.Tensor:
        """The rank's block of a global (B, T) or (accum, B, T) batch, as
        a long tensor on the engine's device."""
        t = torch.as_tensor(a, device=self.device).long()
        return t if self.pctx is None else rank_block(t, self.pctx)

    # -- the train step ----------------------------------------------------

    def _make_executor(self):
        """The lowering's executor (parallel/schedule.py), None for
        "plain" and for "bucket" (built per step)."""
        s = self._schedule
        if self._lowering not in ("prefetch", "composed"):
            return None
        gather = None
        if self.stage >= 3:
            gather = LayerGather(self._z3, hop=self._hop_groups(s.gather),
                                 hpz=self._hpz_groups(s.hpz_geom),
                                 hpz_mode=s.gather.hpz_mode)
        look = (s.gather.prefetch - 1) if s.gather is not None else 0
        lb = None
        if self._lowering == "composed" and s.grad is not None:
            lb = s.layout["layers_per_bucket"]
        exe = sched.ScanExecutor(self, self._lowering, look, lb, gather)
        exe.probe_on = self._layers_on
        return exe

    def _data_groups(self, lists):
        """Every rank list of data ranks as a process group (created in
        order on every rank); this rank's."""
        pctx = self.pctx
        sp = pctx.seq_size
        return new_groups(lists, pctx.data_rank,
                          ranks_of=lambda d: d * sp + pctx.seq_rank)

    def _hop_groups(self, gather):
        if gather is None or not gather.groups:
            return None
        intra, inter = _hier_groups(self.n_shard, gather.groups)
        return (self._data_groups(intra), self._data_groups(inter),
                gather.groups)

    def _hpz_groups(self, geom):
        if geom is None:
            return None
        intra, inter, ici, n_gran = geom
        return (self._data_groups(intra), self._data_groups(inter), ici,
                n_gran)

    def _loss_and_grads(self, params, idx, targets, scale, rng,
                        probe=None):
        """(loss, grads, the probe's gradient or None): the rank's share
        of the global mean differentiated with respect to the params and,
        in telemetry layers mode, the zero (n_layer, 4) `probe` (the
        "probe" lowering, `ProbeScan`)."""
        kw = {"sched": self._exec} if self._lowering == "prefetch" else {}
        wrt = list(params.values())
        if probe is not None:
            gather = self.pctx.gather if self.pctx is not None else None
            kw["sched"] = sched.ProbeScan(probe, gather)
            wrt.append(probe)
        loss = self.model.apply(idx, targets, rng=rng, pctx=self.pctx,
                                params=params, **kw)
        if scale is not None:
            loss = loss * scale
        # the rank's share of the global mean (see the module docstring)
        share = loss if self.pctx is None else loss / self.pctx.world
        grads = torch.autograd.grad(share, wrt)
        probe_grad = grads[-1] if probe is not None else None
        return loss.detach(), dict(zip(params, grads)), probe_grad

    def _reduce(self, grads):
        """The stage's gradient collective over the ranks' shares: SUM
        over the seq group, then over the data group — all-reduced
        (stages 0-1) or reduce-scattered into the rank's flat shard
        (stage 2).  Stage 3's backward already reduce-scattered them."""
        pctx = self.pctx
        if pctx is None or self.stage >= 3:
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
            out[n] = scatter_flat(g, numel, s, hi - lo, pctx.data_group,
                                  self.n_shard)
        return out

    def step(self, state: TrainState, batch):
        """One optimizer step.  batch = (idx, targets), each (B, T) ints
        (numpy or tensors) — or (accum, B, T) when accum_steps > 1; the
        GLOBAL batch on every rank of a distributed engine.  Returns
        (state, loss) with loss the global batch's mean, a 0-d f32 tensor
        on the device.  With the telemetry knob the step's health vector
        (and in layers mode the layer-health matrix) is pushed into the
        telemetry object un-synced."""
        idx, targets = (self._local(a) for a in batch)
        params = state.params
        dynamic = self.loss_scale == "dynamic"
        scale = (state.scaler["scale"] if dynamic
                 else (float(self.loss_scale) if self.loss_scale else None))
        rng = (prng.fold_in(state.dropout_base, state.opt_state["step"])
               if state.dropout_base is not None else None)
        sharded_grads = self.stage >= 2 and self.pctx is not None

        explicit = self._lowering in ("quant_mono", "bucket", "composed")
        # the explicit lowerings run each rank's own batch as on one
        # device: the rank-local mask stream (JAX :1337-1343)
        lrng = (prng.fold_in(rng, self.pctx.data_rank)
                if explicit and rng is not None else None)
        probe0 = probe = None
        if self._layers_on and self._lowering != "composed":
            probe0 = torch.zeros(self.model.config.n_layer,
                                 sched.LAYER_PROBE_WIDTH,
                                 dtype=torch.float32, device=self.device,
                                 requires_grad=True)
        residual = state.grad_residual
        new_residual = residual
        qstep = int(state.opt_state["step"])
        if self._lowering == "quant_mono":
            loss, grads, new_residual = self._quant_mono(
                params, idx, targets, scale, residual, qstep, rng=lrng)
        elif self._lowering == "bucket":
            loss, grads, new_residual = self._bucketed(
                params, idx, targets, scale, residual, qstep, rng=lrng)
        elif self._lowering == "composed":
            loss, grads, new_residual = self._composed(
                params, idx, targets, scale, residual, qstep, rng=lrng)
            if self._layers_on:
                probe = self._exec.probe_stats
                self._exec.probe_stats = None
        elif self.accum_steps == 1:
            loss, grads, probe = self._loss_and_grads(
                params, idx, targets, scale, rng, probe0)
            grads = self._reduce(grads)
        else:
            if idx.dim() != 3 or idx.shape[0] != self.accum_steps:
                raise ValueError(
                    f"accum_steps={self.accum_steps}: batch must be "
                    f"(accum, B, T), got {tuple(idx.shape)}")
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            acc = {}
            for i in range(self.accum_steps):
                l, g, pg = self._loss_and_grads(
                    params, idx[i], targets[i], scale,
                    None if rng is None else prng.fold_in(rng, i), probe0)
                if pg is not None:
                    # raw sq-sums and counts: summed over microbatches
                    # they keep the global batch's meaning
                    probe = pg if i == 0 else probe + pg
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
            if not explicit:  # those unscaled before their collectives
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

        usq = None
        if finite:
            usq = self._update(params, grads, state.opt_state)
        if self._telemetry_on:
            self._push_health(loss, grads, params, usq, probe, scale)
        # a skipped step's sync consumed the residual into a discarded
        # update: it rolls back with the rest of the state (JAX :1367)
        if finite:
            state.grad_residual = new_residual
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

    # -- the update --------------------------------------------------------

    def _slots(self, opt_state, names):
        """(name, its optimizer slots on the device) in order: the
        resting dicts, or under offload the slots streamed through the
        device (parallel/offload.py)."""
        if self._offload is None:
            return ((n, opt_state["state"][n]) for n in names)
        return self._offload.stream(opt_state["state"], names)

    def _usq0(self) -> Optional[torch.Tensor]:
        if not self._telemetry_on:
            return None
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _update_one(self, n, p, g, slots, step, usq):
        """`update_one` of p in place; with `usq` (the telemetry's
        update sq-sum so far) the sum grown by this leaf's (new - old)^2."""
        if usq is None:
            self.optimizer.update_one(n, p, g, slots, step)
            return None
        old = p.detach().clone()
        self.optimizer.update_one(n, p, g, slots, step)
        return usq + (p.detach().float() - old.float()).square().sum()

    # -- telemetry ---------------------------------------------------------

    def _owned(self, params, grads):
        """({name: the gradient piece}, {name: the param piece}) this rank
        sums for the health vector: whole leaves without a process group
        and at stage 0 (replicated), the rank's flat shards at stages 1-2
        (stage 2's gradients already are), ZeRO-3's shards."""
        pp = {n: p.detach() for n, p in params.items()}
        if self.pctx is None or self.stage == 0:
            return grads, pp
        if self.stage == 1:
            grads = {n: self._own(n, g) for n, g in grads.items()}
        if self.stage < 3:
            pp = {n: self._own(n, p) for n, p in pp.items()}
        return grads, pp

    def _layer_grad_partials(self, gp) -> torch.Tensor:
        """(n_layer, 2) [grad sq-sum, non-finite] per layer over this
        rank's pieces of the "h.*" gradients."""
        L = self.model.config.n_layer
        if self.pctx is None or self.stage == 0 or self.stage >= 3:
            return H.layer_grad_stats(gp)
        pieces = []
        for n, g in gp.items():
            if n.startswith("h."):
                numel, _, lo, _ = self._shards[n]
                pieces.append((g, lo, numel // L))
        return H.flat_layer_grad_stats(pieces, L, self.device)

    @torch.no_grad()
    def _push_health(self, loss, grads, params, usq, probe, scale):
        """The (5,) health vector (and the (n_layer, 6) matrix) after the
        update, global, pushed into the telemetry un-synced.  Partial sums
        of owned pieces are all-reduced once over the data group (with the
        probe's sums when the data group spans the world); the probe's
        sums are over each rank's own tokens: SUMmed over the world, the
        composed lowering's dact column divided by n^2 (each rank
        differentiated its own batch's mean, JAX :2325-2336), and the
        dact column unscaled by 1/scale^2 (JAX :1320-1327)."""
        pctx = self.pctx
        gp, pp = self._owned(params, grads)
        if usq is None:
            usq = torch.zeros((), dtype=torch.float32, device=self.device)
        parts = [H.health_partials(gp, pp, usq)]
        if self._layers_on:
            parts.append(self._layer_grad_partials(gp).reshape(-1))
        # owned pieces need the data group's SUM; the probe the world's
        owned = pctx is not None and self.stage >= 1
        pack = owned and probe is not None and pctx.seq_size == 1
        if pack:  # the data group is the world: one all-reduce
            parts.append(probe.reshape(-1))
        packed = torch.cat(parts)
        if owned:
            dist.all_reduce(packed, op=_SUM, group=pctx.data_group)
        if pack:
            probe = packed[-probe.numel():].view(probe.shape)
        elif probe is not None and pctx is not None:
            probe = probe.clone()
            dist.all_reduce(probe, op=_SUM, group=pctx.world_group)
        vec = H.health_vector(loss, partials=packed[:4])
        if not self._layers_on:
            self.telemetry.on_step_output(vec)
            return
        L = self.model.config.n_layer
        gl = packed[4:4 + 2 * L].view(L, 2)
        probe = probe.float().clone()
        if self._lowering == "composed":
            probe[:, 2] *= 1.0 / (self.n_shard * self.n_shard)
        if scale is not None:
            probe[:, 2] *= 1.0 / (scale * scale)
        mat = H.layer_health_matrix(probe, grad_stats=gl)
        self.telemetry.on_step_output(vec, layers=mat)

    # -- the explicit lowerings (JAX monolithic_quant_step, bucketed_step,
    #    composed_step) ------------------------------------------------------

    def _n_buckets(self) -> int:
        lay = self._schedule.layout
        return lay["n_buckets"] if lay is not None else 1

    def _split_residual(self, residual):
        """(the buckets' part, the tail's slice) of the rank's residual
        row [b0 | ... | bK-1 | tail]; (None, None) without one."""
        if residual is None:
            return None, None
        lay = self._schedule.layout
        cut = lay["n_buckets"] * lay["bucket_pad"]
        return residual[:cut], residual[cut:]

    @staticmethod
    def _join_residual(parts):
        parts = [p for p in parts if p is not None]
        return torch.cat(parts) if parts else None

    def _release_tail(self, grads, names, inv, residual=None, step=0):
        """Stages 0-2: the non-block leaves' own-batch gradients unscaled,
        cast to the compute dtype, SUMmed over the data group (stage 2:
        reduce-scattered into the flat shard), divided by the rank count
        — JAX's compute-dtype `pmean` — back in the param dtype.  With a
        codec: one quantized sync of their f32 gradients with the tail's
        residual slice, site (K, K) of the step's stream.  Returns
        (grads, the tail's new residual slice or None)."""
        cd = self.model.config.compute_dtype
        out = {}
        if self._codec is not None:
            tail = {}
            for n in names:
                g = grads[n].float()
                tail[n] = g * inv if inv is not None else g
            k = self._n_buckets()
            red, new_t = self._codec.sync(tail, residual, step, (k, k))
            for n in names:
                g = red[n].to(grads[n].dtype)
                out[n] = g if self.stage < 2 else self._own(n, g).clone()
            return out, new_t
        for n in names:
            g = grads[n].float()
            if inv is not None:
                g = g * inv
            g = g.to(cd)
            if self.stage < 2:
                dist.all_reduce(g, op=_SUM, group=self.pctx.data_group)
            else:
                numel, s, lo, hi = self._shards[n]
                g = scatter_flat(g, numel, s, hi - lo, self.pctx.data_group,
                                 self.n_shard)
            out[n] = (g / self.n_shard).to(grads[n].dtype)
        return out, None

    def _local_loss_grads(self, params, idx, targets, scale, rng=None):
        """The rank's own batch as on one device (the model with no
        pctx; its dropout masks drawn from `rng`, the rank-local key):
        its scaled loss and gradients."""
        l = self.model.apply(idx, targets, params=params, rng=rng)
        if scale is not None:
            l = l * scale
        return l.detach(), torch.autograd.grad(l, list(params.values()))

    def _quant_mono(self, params, idx, targets, scale, residual, step,
                    rng=None):
        """The "quant_mono" lowering's loss and grads (JAX
        `monolithic_quant_step`): each rank's own-batch gradient with the
        model run as on one device, microbatches summed locally (their
        masks from `fold_in(rng, i)`, JAX :1356), unscaled, then one
        quantized sync (`Codec.sync`, the step's stream).
        Returns (the scaled loss averaged over the ranks, the mean
        gradients — whole leaves at stages 0-1, flat shards at stage 2 —,
        the new residual row or None)."""
        accum = self.accum_steps
        if accum == 1:
            loss, got = self._local_loss_grads(params, idx, targets, scale,
                                               rng)
            g = dict(zip(params, got))
        else:
            if idx.dim() != 3 or idx.shape[0] != accum:
                raise ValueError(f"accum_steps={accum}: batch must be "
                                 f"(accum, B, T), got {tuple(idx.shape)}")
            loss, acc = None, {}
            for i in range(accum):
                l, got = self._local_loss_grads(
                    params, idx[i], targets[i], scale,
                    None if rng is None else prng.fold_in(rng, i))
                loss = l if i == 0 else loss + l
                for n, t in zip(params, got):
                    acc[n] = t.float() if i == 0 else acc[n] + t.float()
            loss = loss / accum
            g = {n: (acc[n] / accum).to(p.dtype) for n, p in params.items()}
        if scale is not None:
            # unscaled BEFORE the sync: the residual carries true
            # gradient units
            inv = 1.0 / scale
            g = {n: (t.float() * inv).to(t.dtype) for n, t in g.items()}
        red, new_residual = self._codec.sync(g, residual, step)
        grads = {n: red[n] if self.stage < 2 else self._own(n, red[n]).clone()
                 for n in params}
        dist.all_reduce(loss, op=_AVG, group=self.pctx.world_group)
        return loss, grads, new_residual

    def _bucketed(self, params, idx, targets, scale, residual=None,
                  step=0, rng=None):
        """The "bucket" lowering's loss and grads (JAX `bucketed_step`):
        (the scaled loss averaged over the ranks, the mean gradients
        unscaled — whole leaves at stages 0-1, flat shards at stage 2 —,
        the new residual row or None).  Microbatch i draws its masks from
        `fold_in(rng, i)` (JAX :1581, :1610), a single batch from `rng`."""
        inv = None if scale is None else 1.0 / scale
        tail = [n for n in params if not n.startswith("h.")]
        accum = self.accum_steps
        acc, loss = None, torch.zeros((), dtype=torch.float32,
                                      device=self.device)
        if accum > 1:
            if idx.dim() != 3 or idx.shape[0] != accum:
                raise ValueError(f"accum_steps={accum}: batch must be "
                                 f"(accum, B, T), got {tuple(idx.shape)}")
            acc = {}
            for i in range(accum - 1):  # the prefix, summed locally
                l = self.model.apply(
                    idx[i], targets[i], params=params,
                    rng=None if rng is None else prng.fold_in(rng, i))
                if scale is not None:
                    l = l * scale
                g = torch.autograd.grad(l, list(params.values()))
                loss = loss + l.detach()
                for n, t in zip(params, g):
                    acc[n] = t.float() if i == 0 else acc[n] + t.float()
            idx, targets = idx[-1], targets[-1]
            if rng is not None:
                rng = prng.fold_in(rng, accum - 1)
        bres, tres = self._split_residual(residual)
        rel = sched.BucketRelease(self, acc, accum, inv, residual=bres,
                                  step=step)
        l = self.model.apply(idx, targets, params=params, sched=rel,
                             rng=rng)
        if scale is not None:
            l = l * scale
        got = torch.autograd.grad(l, [params[n] for n in tail]
                                  + [rel.anchor])
        loss = (loss + l.detach()) / accum
        g_tail = dict(zip(tail, got))
        if acc is not None:
            g_tail = {n: ((acc[n] + g.float()) / accum).to(g.dtype)
                      for n, g in g_tail.items()}
        grads, new_t = self._release_tail(g_tail, tail, inv, tres, step)
        grads.update(rel.finish(params))
        dist.all_reduce(loss, op=_AVG, group=self.pctx.world_group)
        new_residual = None
        if residual is not None:
            new_residual = self._join_residual(rel.new_residual + [new_t])
        return loss, {n: grads[n] for n in params}, new_residual

    def _composed(self, params, idx, targets, scale, residual=None,
                  step=0, rng=None):
        """The "composed" lowering's loss and grads (JAX `composed_step`):
        the executor releases the block leaves; the tail — ZeRO-3: its
        gather's reduce-scatter SUM times 1/(scale * D), or with
        `grad_comm_tail` one quantized sync of the whole leaves'
        gradients (JAX `qtail`, :2188-2220), each rank keeping its shard;
        stages 0-2: as `_release_tail`.  The masks come from `rng` (the
        embedding's and each layer's key split from it, JAX :1834-1838).
        Returns (loss, grads, the new residual row or None)."""
        exe = self._exec
        inv = None if scale is None else 1.0 / scale
        exe.inv = inv
        bres, tres = self._split_residual(residual)
        exe.residual, exe.step = bres, step
        tail = [n for n in params if not n.startswith("h.")]
        tail_q = self.stage >= 3 and self._tail_codec is not None
        exe.tail_whole = {} if tail_q else None
        try:
            l = self.model.apply(idx, targets, params=params, sched=exe,
                                 rng=rng)
            if scale is not None:
                l = l * scale
            wrt = dict(params)
            if tail_q:
                wrt.update(exe.tail_whole)
            got = torch.autograd.grad(l, list(wrt.values()))
        finally:
            exe.tail_whole = None
        grads = dict(zip(wrt, got))
        new_t = None
        if tail_q:
            g32 = {}
            for n in tail:
                g = grads[n].float()
                g32[n] = g * inv if inv is not None else g
            k = self._n_buckets()
            red, new_t = self._tail_codec.sync(g32, tres, step, (k, k))
            for n in tail:
                grads[n] = self._own(n, red[n]).to(params[n].dtype).clone()
        elif self.stage >= 3:
            f = (1.0 if inv is None else inv) / self.n_shard
            for n in tail:
                grads[n] = (grads[n].float() * f).to(grads[n].dtype)
        else:
            g_tail, new_t = self._release_tail(grads, tail, inv, tres, step)
            grads.update(g_tail)
            if self.stage == 2:
                grads = {n: (g if n in tail else self._own(n, g))
                         for n, g in grads.items()}
        loss = l.detach()
        dist.all_reduce(loss, op=_AVG, group=self.pctx.world_group)
        new_residual = None
        if residual is not None:
            new_residual = self._join_residual(
                (exe.new_residual or []) + [new_t])
        return loss, {n: grads[n] for n in params}, new_residual

    @torch.no_grad()
    def _update(self, params, grads, opt_state) -> Optional[torch.Tensor]:
        """The optimizer's per-leaf `update_one`, in place, leaf by leaf
        in the params' order (`Optimizer.update`'s loop); under offload
        the state streamed through the device.  Stage 0 updates whole
        leaves.  ZeRO-1/2: each rank updates its flat shard of every leaf
        and the shard's state, then all-gathers the leaf.  ZeRO-3: the
        params ARE the shards; nothing is gathered.  Returns the update's
        sq-sum over what this rank updated when the telemetry is on, else
        None."""
        step = opt_state["step"] + 1
        usq = self._usq0()
        for n, slots in self._slots(opt_state, list(params)):
            p = params[n]
            if self.stage == 0 or self.stage >= 3:
                own, flat = p.detach(), None
            else:
                flat = p.detach().reshape(-1)
                own = self._own(n, flat)
            g = grads[n] if self.stage != 1 else self._own(n, grads[n])
            if own.numel():
                usq = self._update_one(n, own, g, slots, step, usq)
            if flat is not None:
                flat.copy_(self._gather(n, own))
        opt_state["step"] = step
        return usq

    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch) -> torch.Tensor:
        """Mean loss on one global (B, T) batch — forward only, no state
        change."""
        idx, targets = (self._local(a) for a in batch)
        loss = self.model.apply(idx, targets, pctx=self.pctx,
                                params=state.params)
        if self.pctx is not None:
            dist.all_reduce(loss, op=_AVG, group=self.pctx.world_group)
        return loss

    # -- whole-state views and reporting -----------------------------------

    def gather_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """A copy of the whole params (replicated in stages 0-2)."""
        return {n: p.detach().clone() for n, p in state.params.items()}

    @torch.no_grad()
    def load_params(self, state: TrainState,
                    params: Dict[str, torch.Tensor]) -> TrainState:
        """Overwrite the state's params with whole leaves (a checkpoint's,
        or the JAX package's through `convert.params_from_numpy`), in
        place; ZeRO-3 keeps each rank's shards of them."""
        for n, p in state.params.items():
            p.copy_(params[n])
        return state

    @torch.no_grad()
    def gather_opt_state(self, state: TrainState) -> Dict[str, Any]:
        """The optimizer state with whole leaves (all-gathered from the
        data ranks' shards from stage 1 on), to compare with JAX's; on the
        engine's device, offloaded or not."""
        opt = self._resting_opt(state)
        if self.stage == 0:
            return {"step": opt["step"],
                    "state": {n: {k: t.to(self.device, copy=True)
                                  for k, t in slots.items()}
                              for n, slots in opt["state"].items()}}
        shapes = self.model.param_shapes()
        return {"step": opt["step"],
                "state": {n: {k: self._gather(n, t.to(self.device))
                              .reshape(shapes[n])
                              for k, t in slots.items()}
                          for n, slots in opt["state"].items()}}

    def _resting_opt(self, state: TrainState) -> Dict[str, Any]:
        """The state's optimizer state, once the offloaded moments' last
        copies to the host have landed."""
        if self._offload is not None:
            self._offload.wait()
        return state.opt_state

    def _knob_extras(self) -> str:
        """describe()'s offload and telemetry parts (JAX :1498-1502)."""
        out = ""
        if self.offload_opt_state:
            out += ", opt state offloaded=pinned_host"
        if self._telemetry_on:
            out += (", telemetry=layers" if self._layers_on
                    else ", telemetry=on")
        return out

    def describe(self) -> str:
        extras = ""
        if self.grad_clip is not None:
            extras += f", grad_clip={self.grad_clip}"
        if self.loss_scale is not None:
            extras += f", loss_scale={self.loss_scale}"
        extras += self._knob_extras()
        s = self._schedule
        if s.grad is not None and s.grad.mode != "fp32":
            extras += f", grad_comm={s.grad.mode}"
            if s.grad.groups:
                extras += f"(2-hop inner={s.grad.groups})"
            if not s.grad.error_feedback:
                extras += "(no-ef)"
            if s.grad.tail_mode != "fp32":
                extras += f", grad_comm_tail={s.grad.tail_mode}"
        if s.grad is not None and s.grad.buckets > 1:
            extras += f", grad_buckets={s.grad.buckets}"
        if s.gather is not None and s.gather.prefetch > 1:
            extras += f", gather_prefetch={s.gather.prefetch}"
            if s.gather.groups:
                extras += f"(2-hop inner={s.gather.groups})"
        if s.gather is not None and s.gather.hpz:
            extras += ", hpz=on"
            if s.gather.hpz_mode != "fp32":
                extras += f"[{s.gather.hpz_mode}]"
        if self._lowering != "plain":
            extras += f", sched={s.describe()}"
        return (f"{type(self).__name__}(stage={self.stage}, "
                f"devices={self.n_dev}, accum={self.accum_steps}, params "
                f"sharded={self.stage >= 3}, grads sharded="
                f"{self.stage >= 2}, opt state sharded={self.stage >= 1}"
                f"{extras})")


class SingleDevice(ZeroEngine):
    """Stage-0 training on one device (the card unless `device="cpu"`),
    with no process group."""

    stage = 0

    def __init__(self, model, optimizer,
                 device: Union[None, str, torch.device] = None,
                 accum_steps: int = 1, grad_clip: Optional[float] = None,
                 loss_scale=None, loss_scale_growth_interval: int = 2000,
                 grad_buckets=1, gather_prefetch: int = 0,
                 gather_groups=None, hpz: bool = False,
                 hpz_granule_of: Optional[Dict[int, int]] = None,
                 grad_comm: str = "fp32",
                 grad_comm_groups: Optional[int] = None,
                 grad_comm_block: int = 256,
                 grad_comm_error_feedback: bool = True,
                 grad_comm_tail: str = "fp32", hpz_comm: str = "fp32",
                 evenness_priority: float = 0.0,
                 offload_opt_state: bool = False, offload_prefetch: int = 2,
                 telemetry=None, **knobs):
        _refuse("SingleDevice", dict(_REFUSED, seq_parallel=1), knobs,
                "multi-device knobs are")
        knob = _sched_knobs(grad_buckets, gather_prefetch, gather_groups,
                            hpz, grad_comm, grad_comm_groups,
                            grad_comm_block, grad_comm_error_feedback,
                            grad_comm_tail, hpz_comm)
        self._setup(model, optimizer, device, accum_steps, grad_clip,
                    loss_scale, loss_scale_growth_interval,
                    offload_opt_state, offload_prefetch, telemetry)
        self.pctx = None
        self.n_shard = 1
        # one device: every slot is inert, with JAX's warning
        self._build_schedule(knob, hpz_granule_of)
        self._rank_map(evenness_priority)

    def describe(self) -> str:
        return (f"SingleDevice(device={self.device}, "
                f"accum={self.accum_steps}, grad_clip={self.grad_clip}, "
                f"loss_scale={self.loss_scale}{self._knob_extras()})")


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
    """+ params sharded at rest, gathered per layer on demand
    (parallel/zero3.py): the state's params are the rank's f32 shards —
    a flat shard per non-block leaf, an (L, own) per-layer shard per
    block leaf — and the model's own parameters are released at init.
    `gather_params` and `gather_opt_state` return whole leaves."""
    stage = 3

    def __init__(self, model, optimizer, *args, **kw):
        super().__init__(model, optimizer, *args, **kw)
        self._z3 = Zero3Gather(model, self.pctx)
        self.pctx = dataclasses.replace(self.pctx, gather=self._z3)
        self._exec = self._make_executor()

    @torch.no_grad()
    def _shard_model(self, params):
        """The rank's shards of the freshly initialised whole params, as
        new leaves that require grad; the model's whole parameters are
        released (a forward takes the shards: `apply(params=...)`)."""
        shards = {n: self._z3.shard(n, p.detach()).clone().requires_grad_()
                  for n, p in params.items()}
        self._release()
        return shards

    def _release(self):
        """Drop the model's whole parameters (the forward takes shards)."""
        for p in self.model.parameters():
            p.data = p.data.new_empty(0)

    @torch.no_grad()
    def restore(self, params, opt_state, scaler=None,
                dropout_base=None, grad_residual=None) -> TrainState:
        """The checkpoint's shards become the state's params, as new leaves
        that require grad, and the model's whole parameters are released,
        as `init` does — no whole leaf is built."""
        self._release()
        return TrainState(
            params={n: t.detach().requires_grad_() for n, t in params.items()},
            opt_state=self._rest_opt(opt_state), scaler=scaler,
            dropout_base=dropout_base,
            layout=self.layout(),
            grad_residual=self._residual_of(grad_residual))

    def gather_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The whole params, all-gathered from the data ranks' shards."""
        return {n: self._z3.whole(n, p.detach())
                for n, p in state.params.items()}

    @torch.no_grad()
    def gather_opt_state(self, state: TrainState) -> Dict[str, Any]:
        opt = self._resting_opt(state)
        return {"step": opt["step"],
                "state": {n: {k: self._z3.whole(n, t.to(self.device))
                              for k, t in slots.items()}
                          for n, slots in opt["state"].items()}}

    @torch.no_grad()
    def load_params(self, state: TrainState,
                    params: Dict[str, torch.Tensor]) -> TrainState:
        for n, p in state.params.items():
            p.copy_(self._z3.shard(n, params[n].to(p)))
        return state
