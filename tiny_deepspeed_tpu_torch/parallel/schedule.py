# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The in-step collective schedule: ZeRO-3's gather prefetch, the 2-hop
gather and hpZ, the bucketed gradient release, and the per-layer health
probe.

Counterpart of `tiny_deepspeed_tpu/parallel/schedule.py`, its gather and
fp32 grad slots.  Each engine knob becomes a slot declaration; ONE
`build_schedule` (JAX :904-1296) validates the composition, in JAX's
order and with JAX's messages, and picks JAX's lowering:

- "plain": no slot, or every slot inert on a 1-rank data axis (a
  warning; the engine runs its unscheduled path, bit for bit);
- "bucket" (`grad_buckets=K` at stages 0-2): `BucketRelease`, JAX's
  `GradBucketTap` and `bucketed_step` (:441, :1416).  The model's layer
  loop runs as usual, but each bucket of n_layer/K consecutive layers
  reads its stacked weights through an identity autograd Function
  (`_TapFn`) whose backward runs as soon as the bucket's layers have all
  been differentiated — when its gradient is final — and issues the
  bucket's collective there, asynchronously: an all-reduce at stages
  0-1, a reduce-scatter into the rank's flat shard at stage 2.  The tap
  takes the gradient buffer for itself (it returns none to autograd), so
  no autograd kernel reads or accumulates into a buffer in flight.  The
  non-block tail is released after the backward;
- "prefetch" (Zero3 `gather_prefetch=K` alone, optionally the 2-hop
  gather): `ScanExecutor` in JAX's `GatherPrefetchScan` form (:515) —
  the layer loop as one autograd Function whose forward issues layer
  l+K-1's gather (`zero3.LayerGather`) before layer l computes, and whose
  backward walks the layers in reverse, recomputing each from its
  stashed input (remat of the whole block) while layer l-K+1's gather
  is in flight, and reduce-scatters each layer's dW as the on-demand
  gather's transpose does.  The numbers are the on-demand path's;
- "probe" (the health probe alone, `telemetry=Telemetry(layers=True)`):
  `ProbeScan`, JAX's (:396) — the model's own layer loop, each block's
  output through `layer_health_tap` inside its checkpoint, the engine
  differentiating a zero (n_layer, 4) probe with the params;
- "composed" (any other mix: ZeRO-3 with a grad slot — the on-demand
  gather slot is declared implicitly —, hpZ, `grad_buckets` with the fp8
  gather): `ScanExecutor` in JAX's `composed_step` form (:1678).  Each
  rank differentiates its own batch's mean, every layer's dW is kept
  per bucket and released at the bucket boundary as a mean over the data
  group (reduce-scattered back into the rank's ZeRO-3 shard at stage
  3), unscaled before the collective.  Under the fp8 gather a weight's
  cotangent is rounded to e4m3 on each rank before it is released and
  the release is XLA's float8 `pmean` (`comm.f8_sum_mean`), then the
  stacked cast's pullback divides by the scale once: JAX's numbers, not
  the on-demand path's.

The model seam is `model.apply(..., sched=executor)`: the executor's
`prepare` replaces the step's stacking of the block weights and its
`blocks` replaces the layer loop (models/gpt2.py `_blocks`).

Overlap.  Collectives are issued with `async_op=True` and their work
handles kept with their buffers until waited on: the forward waits for a
layer's gathers just before its first read, the backward for a
release's collective when the next release is issued (one in flight) or
at its end.  With NCCL a wait orders the compute stream after the
collective's stream without blocking the host; a buffer is referenced
until it has been waited on, so the allocator cannot hand it out while
NCCL still reads or writes it.  Every rank issues every collective in
the same order: the forward and backward loops run the same layer
sequence on each rank.

The grad-comm codecs (JAX `GradSlot.mode`, parallel/comm.py): with
`grad_comm` int8 or fp8 every gradient release goes through the
error-fed blockwise codec (`comm.start_grad_sync` / `finish_grad_sync`)
instead of an fp32 collective — "quant_mono" (no buckets, stages 0-2:
the engine's `_quant_mono`, JAX `monolithic_quant_step` :1297), each
bucket and the tail of "bucket" (JAX `bucketed_step` :1416), each bucket
of "composed" and, with `grad_comm_tail`, ZeRO-3's non-block tail (JAX
`composed_step` :2088-2220).  The residual row is laid out [bucket 0 |
... | bucket K-1 | tail] (`Schedule.residual_len`).  `hpz_comm` int8 or
fp8 moves hpZ's once-a-step replica rebuild through the codec
(`comm.hpz_rebuild`, JAX `build_sec`).  "auto" resolves `grad_comm`,
`grad_buckets` and `gather_groups` by `auto_comm_plan` (JAX :249).

The probe slot (JAX `ProbeSlot`, `layer_health_tap`): the tap's
gradient carries [act sq-sum, act non-finite, dact sq-sum, dact
non-finite] of each layer's output; inside "composed" `ScanExecutor`
takes them from its recompute and the engine sums them over the data
group, the dact column divided by n^2 (each rank differentiated its own
batch's mean, JAX :2325-2336).

Not ported yet (ROADMAP.md): the pipeline slot (`pipe`).
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.gpt2 import e4m3_round
from ..telemetry.health import nonfinite
from . import comm as C
from .comm import (DEFAULT_BLOCK, GRAD_COMM_MODES, bucket_layout,
                   f8_pmean_shard, f8_pmean_whole, f8_sum_mean, numel,
                   padded_scatter, padded_size, to_codes)
from .mesh import granule_geometry

_SUM = dist.ReduceOp.SUM
_LATER = "not ported yet (a later slice of the port, ROADMAP.md)"


class ScheduleConflictError(ValueError):
    """The refusal path for slot combinations the scheduler cannot emit;
    every message names the conflicting SLOT (JAX :78)."""


@dataclasses.dataclass(frozen=True)
class GatherSlot:
    """Per-layer weight gathers (ZeRO-3): `prefetch` gathered layers held
    live (1 = on demand), `groups` the 2-hop gather's inner size, `hpz`
    the gathers within a granule from its replica, `hpz_mode` the
    replica rebuild's codec (JAX :91)."""
    prefetch: int = 1
    groups: Optional[int] = None
    hpz: bool = False
    hpz_mode: str = "fp32"

    def describe(self) -> str:
        s = f"gather_prefetch={self.prefetch}"
        if self.groups:
            s += f"(2-hop inner={self.groups})"
        if self.hpz:
            s += "+hpz"
            if self.hpz_mode != "fp32":
                s += f"[{self.hpz_mode}]"
        return s


@dataclasses.dataclass(frozen=True)
class GradSlot:
    """Gradient releases (JAX :116): `buckets` layer buckets plus the
    non-block tail, the codec `mode` with `block`-element absmax scales
    and optional error-feedback residual slices, `groups` the 2-hop
    schedule's inner size, `tail_mode` the codec of composed ZeRO-3's
    non-block tail."""
    buckets: int = 1
    mode: str = "fp32"
    block: int = DEFAULT_BLOCK
    groups: Optional[int] = None
    error_feedback: bool = True
    tail_mode: str = "fp32"

    def describe(self) -> str:
        s = f"grad_buckets={self.buckets},grad_comm={self.mode}"
        if self.groups:
            s += f"(2-hop inner={self.groups})"
        if self.mode != "fp32" and not self.error_feedback:
            s += "(no-ef)"
        if self.tail_mode != "fp32":
            s += f",tail_comm={self.tail_mode}"
        return s


@dataclasses.dataclass(frozen=True)
class ProbeSlot:
    """Per-layer health probe (engine telemetry layers mode, JAX :148)."""
    kind: str = "layer_health"

    def describe(self) -> str:
        return "health"


@dataclasses.dataclass
class Schedule:
    """A validated slot composition and its lowering (JAX :857)."""
    gather: Optional[GatherSlot] = None
    grad: Optional[GradSlot] = None
    probe: Optional[ProbeSlot] = None
    lowering: str = "plain"
    layout: Optional[dict] = None
    # the error-feedback residual row's length (0: no residual)
    residual_len: int = 0
    hpz_geom: Optional[tuple] = None
    # the resolved auto_comm_plan when a knob arrived as "auto"
    auto_plan: Optional[dict] = None

    @property
    def slots(self):
        return [s for s in (self.gather, self.grad, self.probe)
                if s is not None]

    def describe(self) -> str:
        if not self.slots:
            return "plain"
        return "+".join(s.describe() for s in self.slots) + \
            f"@{self.lowering}"


# ---------------------------------------------------------------------------
# --sched spec parsing (JAX :177)
# ---------------------------------------------------------------------------

_SPEC_INT = ("gather_prefetch", "gather_groups", "grad_buckets",
             "grad_comm_groups", "grad_comm_block")
_SPEC_AUTO = ("gather_groups", "grad_buckets", "grad_comm")
_SPEC_MODE = ("grad_comm", "grad_comm_tail", "hpz_comm")


def parse_sched_spec(spec: str) -> Dict[str, Any]:
    """A `--sched` composition string -> engine kwargs, e.g.
    "gather_prefetch=2,grad_buckets=4,grad_comm=int8,hpz" ->
    {"gather_prefetch": 2, "grad_buckets": 4, "grad_comm": "int8",
    "hpz": True}.  JAX's vocabulary: `grad_buckets`, `gather_groups` and
    `grad_comm` also take "auto" (`auto_comm_plan`); `grad_comm_tail` and
    `hpz_comm` take a codec; `health` gives {"telemetry_layers": True},
    which is not an engine kwarg: the caller upgrades its Telemetry to
    layers mode (train.py does).  `pipe` (the pipeline slot) is refused
    by name (ROADMAP.md), an unknown key or mode as JAX refuses it."""
    out: Dict[str, Any] = {}
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        if part == "hpz":
            out["hpz"] = True
            continue
        if part == "health":
            out["telemetry_layers"] = True
            continue
        if "=" not in part:
            raise ValueError(f"--sched element {part!r} is not "
                             "'key=value', 'health' or 'hpz'")
        key, val = (s.strip() for s in part.split("=", 1))
        if key == "pipe":
            raise ValueError(f"--sched pipe={val} (the pipeline slot): "
                             f"{_LATER}")
        if val == "auto" and key in _SPEC_AUTO:
            out[key] = "auto"
        elif key in _SPEC_INT:
            out[key] = int(val)
        elif key in _SPEC_MODE:
            if val not in GRAD_COMM_MODES:
                raise ValueError(f"--sched {key} must be one of "
                                 f"{GRAD_COMM_MODES}, got {val!r}")
            out[key] = val
        else:
            raise ValueError(f"unknown --sched key {key!r}")
    return out


# ---------------------------------------------------------------------------
# the "auto" comm sizing (JAX :249-342)
# ---------------------------------------------------------------------------

def auto_comm_plan(*, n_shard: int, n_layer: int, shapes=None,
                   granule_of=None, block: int = DEFAULT_BLOCK,
                   max_buckets: int = 8,
                   overhead_tol: float = 0.10) -> Dict[str, Any]:
    """The "auto" comm knobs from the link hierarchy and the modeled
    bytes (JAX :249): `grad_comm` "int8" whenever there is a gradient
    collective; `grad_buckets` the largest divisor of n_layer (at most
    `max_buckets`, and max(2, max_buckets // granules) over several
    granules) whose padded per-bucket syncs stay within `overhead_tol` of
    the monolithic sync's modeled wire; `gather_inner` the ranks a
    granule over several granules, else None.  A pure function of the
    geometry."""
    n_gran, ici = granule_geometry(granule_of, n_shard)
    plan: Dict[str, Any] = {
        "n_granules": n_gran,
        "grad_comm": "int8" if n_shard > 1 else "fp32",
        "grad_buckets": 1,
        "gather_inner": (ici if n_gran > 1 and 2 <= ici < n_shard
                         and n_shard % ici == 0 else None),
    }
    if n_shard <= 1 or n_layer <= 1 or not shapes:
        return plan
    cap = max_buckets if n_gran <= 1 else max(2, max_buckets // n_gran)
    divisors = [k for k in range(1, min(n_layer, cap) + 1)
                if n_layer % k == 0]
    block_elems = sum(numel(s) for nm, s in shapes.items()
                      if nm.startswith("h."))
    if not block_elems:
        return plan
    mode = plan["grad_comm"]
    base = C.modeled_wire_bytes(block_elems, n_shard, mode, block=block)
    budget = (1.0 + overhead_tol) * base["quant_wire_bytes"]
    best_k, best_wire = 1, base["quant_wire_bytes"]
    for k in divisors:
        per = C.modeled_wire_bytes(block_elems // k, n_shard, mode,
                                   block=block)
        wire_k = k * per["quant_wire_bytes"]
        if wire_k <= budget:
            best_k, best_wire = k, wire_k
    plan["grad_buckets"] = best_k
    plan["modeled"] = {
        "grad_wire_bytes": float(best_wire),
        "grad_wire_bytes_monolithic": float(base["quant_wire_bytes"]),
        "fp32_allreduce_wire_bytes": base["fp32_allreduce_wire_bytes"],
        "dcn_frac_est": 1.0 if n_gran > 1 else 0.0,
    }
    return plan


# the comm knobs a plan may carry, in engine-kwarg spelling (JAX :331)
COMM_PLAN_KEYS = ("grad_comm", "grad_buckets", "grad_comm_tail",
                  "gather_groups", "gather_prefetch", "hpz", "hpz_comm")


def comm_plan_engine_kwargs(plan: Dict[str, Any]) -> Dict[str, Any]:
    """A plan filtered down to the engine kwargs it carries (JAX :337)."""
    return {k: plan[k] for k in COMM_PLAN_KEYS
            if k in plan and plan[k] is not None}


# ---------------------------------------------------------------------------
# hpZ group geometry (JAX :808)
# ---------------------------------------------------------------------------

def hpz_groups(granule_of: Dict[int, int], n: int):
    """(intra, inter, ici, n_gran) rank lists for hpZ over a data axis of
    n ranks whose granule is granule_of[rank]: equal contiguous granules
    (rank r in granule r // ici); intra = one granule's ranks (the
    in-loop gathers), inter = the same position across granules (the one
    rebuild a step)."""
    grans = [granule_of.get(r) for r in range(n)]
    if any(g is None for g in grans):
        raise ScheduleConflictError(
            f"gather slot (hpz): granule map covers {sorted(granule_of)} "
            f"but the data axis has ranks 0..{n - 1}")
    n_gran = len(set(grans))
    if n_gran < 2:
        raise ScheduleConflictError(
            "gather slot (hpz): the mesh has a single DCN granule — "
            "every gather is already intra-slice; hpz would only add "
            "a redundant secondary partition")
    if n % n_gran:
        raise ScheduleConflictError(
            f"gather slot (hpz): {n_gran} granules must evenly divide "
            f"the data axis ({n} ranks)")
    ici = n // n_gran
    if grans != [r // ici for r in range(n)]:
        raise ScheduleConflictError(
            f"gather slot (hpz): granules must be contiguous equal "
            f"blocks of the data axis (expected rank r in granule "
            f"r//{ici}, got {grans})")
    intra = [[g * ici + i for i in range(ici)] for g in range(n_gran)]
    inter = [[g * ici + i for g in range(n_gran)] for i in range(ici)]
    return intra, inter, ici, n_gran


# ---------------------------------------------------------------------------
# build_schedule (JAX :904-1296)
# ---------------------------------------------------------------------------

def build_schedule(*, model, stage: int, n_shard: int, busy_axes=(),
                   accum_steps: int = 1, grad_comm: str = "fp32",
                   grad_comm_block: int = DEFAULT_BLOCK,
                   grad_comm_groups: Optional[int] = None,
                   grad_comm_error_feedback: bool = True,
                   grad_buckets=1, grad_comm_tail: str = "fp32",
                   gather_prefetch: int = 0, gather_groups=None,
                   hpz: bool = False, hpz_comm: str = "fp32",
                   granule_of=None,
                   telemetry_layers: bool = False) -> Schedule:
    """Translate the knobs into slots, validate the composition once and
    pick the lowering, as JAX's does (:904-1296).  `granule_of` is a
    {rank: granule} map or a callable returning one (called only when
    hpZ's geometry or "auto" needs it: the port's map is a collective over
    the hosts' names).  `telemetry_layers` declares the probe slot."""
    n_layer = int(getattr(getattr(model, "config", None), "n_layer", 0)
                  or 0)
    gq = bool(getattr(getattr(model, "config", None), "gather_quant", None))

    def gmap():
        return granule_of() if callable(granule_of) else granule_of

    # ---- resolve "auto" knobs against the link hierarchy --------------------
    auto_plan = None
    if "auto" in (grad_comm, grad_buckets, gather_groups):
        granule_of = gmap()
        auto_plan = auto_comm_plan(
            n_shard=n_shard, n_layer=n_layer, shapes=model.param_shapes(),
            granule_of=granule_of, block=int(grad_comm_block))
        if grad_comm == "auto":
            grad_comm = auto_plan["grad_comm"]
        if grad_buckets == "auto":
            # bucketing pipelines the quantized syncs; an fp32 program has
            # no bucket machinery to size
            grad_buckets = (auto_plan["grad_buckets"]
                            if grad_comm != "fp32" else 1)
        if gather_groups == "auto":
            # the 2-hop gather exists only in the single-slot prefetch
            # lowering; under a composition "auto" means flat
            legacy_prefetch = (gather_prefetch > 1 and not hpz
                               and grad_comm == "fp32"
                               and grad_buckets in (0, 1))
            gather_groups = (auto_plan["gather_inner"]
                             if legacy_prefetch else None)

    # ---- tail / hpz codec preconditions -------------------------------------
    if grad_comm_tail not in GRAD_COMM_MODES:
        raise ValueError(f"grad_comm_tail must be one of {GRAD_COMM_MODES}, "
                         f"got {grad_comm_tail!r}")
    if hpz_comm not in GRAD_COMM_MODES:
        raise ValueError(f"hpz_comm must be one of {GRAD_COMM_MODES}, "
                         f"got {hpz_comm!r}")
    if hpz_comm != "fp32" and not hpz:
        raise ValueError("hpz_comm quantizes the hpZ secondary rebuild; "
                         "it needs hpz=True")
    if grad_comm_tail != "fp32":
        if stage < 3:
            raise ValueError(
                "grad_comm_tail is a ZeRO-3 knob: at stages 0-2 the "
                "non-block tail already syncs through the grad_comm "
                "codec — drop grad_comm_tail or set grad_comm=")
        if grad_comm == "fp32":
            raise ValueError(
                "grad_comm_tail composes with a quantized grad slot "
                "(the tail shares the codec machinery and the residual "
                "row); set grad_comm='int8'/'fp8' first")

    # ---- declare slots from the knobs --------------------------------------
    gather = None
    if hpz or gather_prefetch > 1:
        gather = GatherSlot(prefetch=max(int(gather_prefetch) or 0, 1),
                            groups=gather_groups, hpz=bool(hpz),
                            hpz_mode=str(hpz_comm))
    grad = None
    if grad_buckets > 1 or grad_comm != "fp32":
        grad = GradSlot(buckets=max(int(grad_buckets), 1), mode=grad_comm,
                        block=int(grad_comm_block), groups=grad_comm_groups,
                        error_feedback=bool(grad_comm_error_feedback),
                        tail_mode=str(grad_comm_tail))
    probe = ProbeSlot() if telemetry_layers else None
    # ZeRO-3 with a grad slot: the on-demand gather slot, implicitly
    if stage >= 3 and grad is not None and gather is None:
        gather = GatherSlot(prefetch=1)
    if gather is None and grad is None and probe is None:
        return Schedule(lowering="plain")

    # ---- single-feature inert fallbacks (1-rank data axis) -----------------
    if n_shard <= 1:
        if grad is not None:
            warnings.warn(
                f"grad slot ({grad.describe()}) is inert on a 1-device "
                "data axis (there is no gradient collective); running "
                "the exact unscheduled path", stacklevel=3)
            grad = None
        if gather is not None:
            warnings.warn(
                f"gather slot ({gather.describe()}) is inert on a "
                "1-device data axis (there is no weight gather); running "
                "the on-demand path", stacklevel=3)
            gather = None
        if probe is None:
            return Schedule(lowering="plain")

    slots = [s for s in (gather, grad, probe) if s is not None]
    multi = (len(slots) > 1
             or (gather is not None
                 and (gather.hpz or gather.prefetch == 1))
             or (grad is not None and grad.buckets > 1 and gq))

    # ---- composition validation --------------------------------------------
    if multi:
        if accum_steps > 1:
            raise ScheduleConflictError(
                f"the composed schedule "
                f"({'+'.join(s.describe() for s in slots)}) does not "
                f"support accum_steps={accum_steps} yet — prefix "
                f"microbatches would bypass the probe/gather slots; "
                f"drop a slot or set accum_steps=1")
        if gather is not None and gather.groups:
            raise ScheduleConflictError(
                f"gather slot: the 2-hop gather (gather_groups="
                f"{gather.groups}) is only emitted by the single-slot "
                f"prefetch lowering; it conflicts with "
                f"{'+'.join(s.describe() for s in slots if s is not gather)}")
        if grad is not None and n_layer and n_layer % grad.buckets:
            raise ValueError(
                f"grad_buckets={grad.buckets} must divide "
                f"n_layer={n_layer} (equal layers per bucket is what "
                "keeps the buckets size-balanced and the scan body "
                "uniform)")
        for s, flag in ((gather, "gather_prefetch_capable"),
                        (grad, "grad_bucket_capable"),
                        (probe, "layer_health_capable")):
            if s is not None and not getattr(model, flag, False):
                raise ScheduleConflictError(
                    f"{type(model).__name__} cannot run the "
                    f"{s.describe()} slot through the composed scan "
                    f"({flag}=False — e.g. the MoE scan carries an "
                    f"aux-loss accumulator the merged scan body does "
                    f"not thread)")

    # ---- slot-level validation ---------------------------------------------
    busy = [ax for ax in busy_axes if ax is not None]
    if probe is not None:
        if not getattr(model, "layer_health_capable", False):
            raise ValueError(
                f"{type(model).__name__} does not thread the per-layer "
                "health probe through its layer scan "
                "(layer_health_capable=False)")
        if not n_layer:
            raise ValueError("telemetry layers mode needs a layered model "
                             "(config.n_layer)")
    if grad is not None:
        if grad.mode not in GRAD_COMM_MODES:
            raise ValueError(f"grad_comm must be one of {GRAD_COMM_MODES}, "
                             f"got {grad.mode!r}")
        if busy:
            raise ValueError(
                f"the grad slot needs a pure data-parallel mesh (the "
                f"explicit schedule replays the model inside a shard_map "
                f"over the data axis); active axes: {busy}")
        if grad.buckets > 1 and not getattr(model, "grad_bucket_capable",
                                            False):
            raise ValueError(
                f"{type(model).__name__} does not thread the bucketed "
                "grad-release tap through its layer scan "
                "(grad_bucket_capable=False)")
        if grad.groups is not None and (
                grad.groups < 2 or grad.groups >= n_shard
                or n_shard % grad.groups):
            raise ValueError(
                f"grad_comm_groups={grad.groups} must be a proper "
                f"divisor of the data-axis size {n_shard} (>= 2)")
    if gather is not None:
        if stage < 3:
            raise ValueError(
                "the gather slot (gather_prefetch / hpz) requires ZeRO-3 "
                "(stages 0-2 keep params replicated/gathered once — "
                "there is no per-layer weight gather to schedule)")
        if not getattr(model, "gather_prefetch_capable", False):
            raise ValueError(
                f"{type(model).__name__} does not thread the scheduled "
                "weight-gather scan through its layer loop "
                "(gather_prefetch_capable=False)")
        if busy:
            raise ValueError(f"the gather slot needs a pure data-parallel "
                             f"mesh; active axes: {busy}")
        if n_layer and gather.prefetch > n_layer:
            raise ValueError(
                f"gather_prefetch={gather.prefetch} holds more layers "
                f"than the model has (n_layer={n_layer})")
        if gather.groups is not None and (
                gather.groups < 2 or gather.groups >= n_shard
                or n_shard % gather.groups):
            raise ValueError(
                f"gather_groups={gather.groups} must be a proper "
                f"divisor of the data-axis size {n_shard} (>= 2)")

    # ---- hpZ geometry -------------------------------------------------------
    geom = None
    if gather is not None and gather.hpz:
        granule_of = gmap()
        if granule_of is None:
            raise ScheduleConflictError(
                "gather slot (hpz): no DCN granule map — the mesh spans "
                "a single slice/process (parallel/mesh.granule_map "
                "returned None) and no granule_of= override was given")
        geom = hpz_groups(granule_of, n_shard)

    # ---- pick the lowering --------------------------------------------------
    layout = None
    residual_len = 0
    if grad is not None:
        shapes = model.param_shapes()
        stack_dims = [getattr(s, "shape", s)[0] for nm, s in shapes.items()
                      if nm.startswith("h.")]
        if grad.buckets > 1 and not stack_dims:
            raise ValueError("grad_buckets needs a stacked-block model (no "
                             "'h.*' leaves to bucket by layer)")
        if grad.buckets > 1 or multi:
            layout = bucket_layout(shapes, stack_dims[0], grad.buckets,
                                   n_shard, grad.block)
        if grad.mode != "fp32" and grad.error_feedback:
            if layout is not None:
                residual_len = grad.buckets * layout["bucket_pad"]
                # composed ZeRO-3 with an fp32 tail: the tail
                # reduce-scatters through its gather, no residual slice
                if stage < 3 or grad.tail_mode != "fp32":
                    residual_len += layout["tail_pad"]
            else:
                total = sum(numel(s) for s in shapes.values())
                residual_len = padded_size(total, n_shard, grad.block)
    if multi:
        lowering = "composed"
    elif probe is not None:
        lowering = "probe"
    elif grad is not None:
        lowering = "bucket" if grad.buckets > 1 else "quant_mono"
    else:
        lowering = "prefetch"
    return Schedule(gather=gather, grad=grad, probe=probe,
                    lowering=lowering, layout=layout,
                    residual_len=residual_len, hpz_geom=geom,
                    auto_plan=auto_plan)


# ---------------------------------------------------------------------------
# the per-layer health probe (JAX :345-410)
# ---------------------------------------------------------------------------

# probe row width: [act_sq, act_nonfinite, dact_sq, dact_nonfinite]
LAYER_PROBE_WIDTH = 4


def _act_stats(x: torch.Tensor) -> torch.Tensor:
    """(2,) f32 [sum of squares, non-finite element count] of one layer's
    output (or its gradient), over the tensor this rank holds."""
    xf = x.detach().float()
    return torch.stack([xf.square().sum(), nonfinite(xf)])


class _HealthTap(torch.autograd.Function):
    """Identity on x; the probe row's gradient is [act stats, dact
    stats], both taken in the backward: x is saved, which costs nothing
    a checkpoint or the next block's input does not already keep (inside
    a checkpoint the recompute hands the same x back)."""

    @staticmethod
    def forward(ctx, x, probe):
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g, torch.cat([_act_stats(x), _act_stats(g)])


def layer_health_tap(x: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """Identity on `x` (a block's output); the (4,) f32 `probe` row's
    GRADIENT comes back as [act sq-sum, act non-finite count, d(act)
    sq-sum, d(act) non-finite count] (JAX :363): the engine
    differentiates the loss with respect to a zero (n_layer, 4) probe
    whose row l taps layer l, so the per-layer stats leave the backward
    with no extra host transfer."""
    return _HealthTap.apply(x, probe)


class ProbeScan:
    """The "probe" lowering's executor (JAX `ProbeScan`, :396): the
    model's own layer loop, each block called with its probe row, which
    the block taps inside its checkpoint (models/gpt2.py `_block_fn`).
    `gather` is ZeRO-3's on-demand gather (`Zero3Gather`): the step's
    stacking goes through its `prepare`, and each block gathers its own
    layer as without the probe."""

    def __init__(self, probe: torch.Tensor, gather=None, pctx=None):
        self.probe = probe
        self.gather = gather
        self.pctx = pctx

    def prepare(self, model, params):
        if self.gather is not None:
            return self.gather.prepare(params)
        return params, model.stacked_compute_params(params, self.pctx)

    def blocks(self, model, x, stacked, dkeys, pctx=None):
        block = model._block_fn()
        for bp, dkey, row in zip(model._layers(stacked), dkeys,
                                 self.probe.unbind(0)):
            x = block(x, bp, dkey, pctx, probe=row)
        return x, None


# ---------------------------------------------------------------------------
# the bucket lowering: the tap and its release (JAX :419-507, :1416)
# ---------------------------------------------------------------------------

class _TapFn(torch.autograd.Function):
    """Identity on one bucket's stacked chunks; its backward hands their
    (final) gradients to the release and returns none of them.  `anchor`
    (a 0-d tensor that requires grad) is what makes the outputs
    differentiable and the backward run: the chunks are detached."""

    @staticmethod
    def forward(ctx, release, b, anchor, *chunks):
        ctx.release, ctx.b = release, b
        return tuple(c.view_as(c) for c in chunks)

    @staticmethod
    def backward(ctx, *grads):
        ctx.release.release(ctx.b, grads)
        return (None, None, torch.zeros((), device=grads[0].device),
                *[None] * len(grads))


@dataclasses.dataclass
class Codec:
    """A grad slot's codec as a release runs it (JAX `GradSlot.mode`,
    `block`, `groups`): the data `group` of `n` ranks, this rank's data
    `rank` (the dither's stream), and under the 2-hop schedule `inner`
    with `hops` = (intra group, inter group)."""
    mode: str
    group: Any
    n: int
    rank: int = 0
    block: int = DEFAULT_BLOCK
    inner: Optional[int] = None
    hops: Optional[tuple] = None

    def start(self, grads, residual, step: int, site=None):
        """`comm.start_grad_sync` of {name: f32 grad} with this rank's
        residual slice (or None); int8 draws its dither from (step, rank,
        site)."""
        key = (C.SyncKey(int(step), self.rank, site)
               if self.mode == "int8" else None)
        return C.start_grad_sync(grads, residual, self.group, self.n,
                                 self.mode, block=self.block, key=key,
                                 inner=self.inner, hops=self.hops)

    def sync(self, grads, residual, step: int, site=None):
        """The whole sync: ({name: mean}, new residual or None)."""
        return C.finish_grad_sync(self.start(grads, residual, step, site))


class BucketRelease:
    """The bucket lowering's executor for one step (stages 0-2): each
    bucket's gradient all-reduced (stages 0-1) or reduce-scattered into
    the rank's flat shard (stage 2) from inside the backward, in the
    compute dtype, then divided by the rank count — JAX's compute-dtype
    `pmean` of each rank's own-batch gradient.  With the engine's codec
    (`engine._codec`) each bucket goes through the error-fed
    quantized sync instead (JAX `bucket_reduce`, :1499-1545): its f32
    gradient, its slice of `residual` (the rank's row, [b0 | ... | bK-1 |
    tail]) and the site (b, K) of the `step`'s dither stream; its reduce-
    scatter is issued from the backward, the all-gather in `finish`, and
    `new_residual` holds the buckets' new slices after it.

    `acc` ({name: f32 summed gradient of the earlier microbatches}) and
    `accum` fold accumulation in as JAX's final-microbatch taps do;
    `inv` unscales before the collective; `n_buckets` defaults to the
    engine's schedule's.  Every buffer a collective reads or writes is
    held until `finish` has waited on it."""

    def __init__(self, engine, acc=None, accum: int = 1, inv=None,
                 n_buckets: Optional[int] = None,
                 residual: Optional[torch.Tensor] = None, step: int = 0):
        self.eng = engine
        self.k = n_buckets or engine._schedule.layout["n_buckets"]
        self.lb = engine.model.config.n_layer // self.k
        self.acc, self.accum, self.inv = acc, accum, inv
        self.codec = getattr(engine, "_codec", None)
        self.residual, self.step = residual, step
        self.new_residual: Optional[List[torch.Tensor]] = None
        if self.codec is not None:
            self.bpad = bucket_layout(
                engine.model.param_shapes(), engine.model.config.n_layer,
                self.k, self.codec.n, self.codec.block)["bucket_pad"]
        self.anchor = torch.zeros((), device=engine.device,
                                  requires_grad=True)
        self.names: List[str] = []
        self.pending: List[tuple] = []

    # -- the model seam ---------------------------------------------------

    def prepare(self, model, params):
        """The step's stacked compute-dtype block weights, detached (the
        taps own their gradients); the non-block leaves as they are."""
        stacked = model.stacked_compute_params(
            {n: p.detach() for n, p in params.items() if n.startswith("h.")})
        return params, stacked

    def blocks(self, model, x, stacked, dkeys, pctx=None):
        self.names = list(stacked)
        block = model._block_fn()
        layers = []
        for b in range(self.k):
            sl = slice(b * self.lb, (b + 1) * self.lb)
            outs = _TapFn.apply(self, b, self.anchor,
                                *[stacked[n][sl] for n in self.names])
            cols = [o.unbind(0) for o in outs]
            layers += [dict(zip(self.names, ls)) for ls in zip(*cols)]
        for bp, dkey in zip(layers, dkeys):
            x = block(x, bp, dkey, None)
        return x, None

    # -- the releases -------------------------------------------------------

    def release(self, b: int, grads) -> None:
        """Bucket b's collective, from inside the backward: f32, plus the
        earlier microbatches' share over accum, unscaled, then issued
        asynchronously — cast to the compute dtype for the fp32 sum, or
        into the codec's reduce-scatter."""
        eng = self.eng
        sl = slice(b * self.lb, (b + 1) * self.lb)
        red = []
        for n, g in zip(self.names, grads):
            f = g.float()
            if self.acc is not None:
                f = (f + self.acc["h." + n][sl]) / self.accum
            if self.inv is not None:
                f = f * self.inv
            red.append(f if self.codec is not None else f.to(g.dtype))
        if self.codec is not None:
            res = (None if self.residual is None else
                   self.residual[b * self.bpad:(b + 1) * self.bpad])
            p = self.codec.start(dict(zip(self.names, red)), res, self.step,
                                 (b, self.k))
            self.pending.append((b, p, [g.dtype for g in grads]))
            return
        pctx = eng.pctx
        if eng.stage < 2:
            flat = torch.cat([r.reshape(-1) for r in red])
            work = dist.all_reduce(flat, op=_SUM, group=pctx.data_group,
                                   async_op=True)
            self.pending.append((b, work, flat, red))
            return
        per = []
        for n, r in zip(self.names, red):
            numel, s, _, _ = eng._shards["h." + n]
            lo = b * self.lb * (numel // eng.model.config.n_layer)
            hi = lo + r.numel()
            work, buf, out, part = padded_scatter(
                r.reshape(-1), lo, hi, s, eng.n_shard, pctx.data_group,
                async_op=True)
            per.append((n, work, (buf, out), part))
        self.pending.append((b, per))

    def finish(self, params) -> Dict[str, torch.Tensor]:
        """Wait for every bucket's collective; the block leaves' reduced
        gradients in the params' dtype — whole leaves (stages 0-1) or the
        rank's flat shards (stage 2)."""
        if self.codec is not None:
            return self._finish_codec(params)
        eng = self.eng
        n = eng.n_shard
        out: Dict[str, torch.Tensor] = {}
        if eng.stage < 2:
            chunks = {nm: [None] * self.k for nm in self.names}
            for b, work, flat, red in self.pending:
                work.wait()
                flat = flat / n
                off = 0
                for nm, r in zip(self.names, red):
                    chunks[nm][b] = flat[off:off + r.numel()].view(r.shape)
                    off += r.numel()
            for nm in self.names:
                out["h." + nm] = torch.cat(chunks[nm]).to(
                    params["h." + nm].dtype)
        else:
            for nm in self.names:
                numel, s, lo, hi = eng._shards["h." + nm]
                out["h." + nm] = params["h." + nm].new_zeros(hi - lo)
            for _, per in self.pending:
                for nm, work, (_, got), (a, z) in per:
                    work.wait()
                    _, _, lo, _ = eng._shards["h." + nm]
                    if z > a:
                        out["h." + nm][a - lo:z - lo] = got[:z - a] / n
        self.pending = []
        return out

    def _finish_codec(self, params) -> Dict[str, torch.Tensor]:
        """The codec's second halves, bucket by bucket in issue order: the
        mean in the compute dtype (JAX casts the release back to the
        tap's), then the param dtype — whole leaves, or at stage 2 the
        rank's part of each bucket's range."""
        eng = self.eng
        chunks = {nm: [None] * self.k for nm in self.names}
        new_res = [None] * self.k
        for b, p, dtypes in self.pending:
            red, new_res[b] = C.finish_grad_sync(p)
            for nm, dt in zip(self.names, dtypes):
                chunks[nm][b] = red[nm].to(dt)
        self.pending = []
        if self.residual is not None:
            self.new_residual = new_res
        out: Dict[str, torch.Tensor] = {}
        for nm in self.names:
            whole = torch.cat(chunks[nm]).to(params["h." + nm].dtype)
            out["h." + nm] = (whole if eng.stage < 2
                              else eng._own("h." + nm, whole).clone())
        return out


# ---------------------------------------------------------------------------
# the prefetch and composed lowerings: the layer loop as one Function
# ---------------------------------------------------------------------------

class _Live:
    """Bytes of gathered layer weights the executor holds, and the peak."""

    def __init__(self):
        self.now = self.peak = 0

    def add(self, b: int):
        self.now += b
        self.peak = max(self.peak, self.now)

    def sub(self, b: int):
        self.now -= b


class _ScanFn(torch.autograd.Function):
    """The layer loop of `ScanExecutor`: forward and backward as JAX's
    custom_vjp pair (`GatherPrefetchScan.scan`, `composed_step.run`)."""

    @staticmethod
    def forward(ctx, exe, keys, dkeys, grad_on, x0, *vals):
        stacked = dict(zip(keys, vals))
        y, saved = exe.forward(x0, stacked, dkeys, grad_on)
        ctx.exe, ctx.keys, ctx.dkeys, ctx.saved = exe, keys, dkeys, saved
        ctx.stacked = stacked
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, grads = ctx.exe.backward(dy, ctx.stacked, ctx.dkeys, ctx.saved)
        ctx.saved = ctx.stacked = None
        return (None, None, None, None, dx,
                *[grads.get(k) for k in ctx.keys])


class ScanExecutor:
    """The scheduled layer loop.

    mode "prefetch" (JAX `GatherPrefetchScan`): layer l+look's gather in
    flight while layer l computes (look = K-1), forward and backward; the
    backward recomputes each block from its stashed input and
    reduce-scatters each layer's dW as `GatherFn` / `GatherFp8Fn`'s
    backward does (under the 2-hop gather, JAX's f32 pullback of the
    dequant: e4m3(dW * scale) / scale on the shard).  The engine's own
    step runs around it, so the numbers are the on-demand path's.

    mode "composed" (JAX `composed_step`): the same loop, over the
    resting shards (stage 3, any gather route, look >= 0) or the whole
    stacked weights (stages 0-2); each rank differentiates its own
    batch's mean and every bucket of `lb` layers (each layer, without a
    grad slot) is released as a mean over the data group: the compute
    dtype's sum divided by the rank count, or XLA's float8 pmean of the
    e4m3 cotangents under the fp8 gather; unscaled by `inv` first.

    With a `codec` (composed with a grad slot; the engine's, by default)
    each bucket's f32 dW goes through the error-fed quantized sync
    instead (JAX `composed_step` :2088-2112): its slice of `residual`
    (the rank's row) and the site (b, K) of the `step`'s dither stream;
    the full mean comes back and each rank keeps its shard's part.
    `new_residual` holds the buckets' new slices after the backward.

    `live` counts the bytes of gathered layer weights it holds (issued
    and not yet dropped): at most `look + 1` layers' worth.

    With `probe_on` (the probe slot inside "composed", JAX
    `composed_step`'s tapped blocks) the backward writes each layer's
    [act sq-sum, act non-finite, dact sq-sum, dact non-finite] — of its
    recomputed output and of that output's gradient, over this rank's
    batch — into `probe_stats` (n_layer, 4) f32."""

    def __init__(self, engine, mode: str, look: int, lb: Optional[int],
                 gather=None, codec=None):
        self.eng, self.mode, self.look, self.lb = engine, mode, look, lb
        self.g = gather  # zero3.LayerGather (stage 3) or None
        self.model = engine.model
        self.cd = self.model.config.compute_dtype
        self.n = engine.n_shard
        self.group = engine.pctx.data_group
        self.inv: Optional[float] = None
        self.codec = codec
        if codec is None and mode == "composed" and lb is not None:
            self.codec = getattr(engine, "_codec", None)
        self.residual: Optional[torch.Tensor] = None
        self.step = 0
        self.new_residual: Optional[List[torch.Tensor]] = None
        self.tail_whole: Optional[Dict[str, torch.Tensor]] = None
        self.probe_on = False
        self.probe_stats: Optional[torch.Tensor] = None
        self.live = _Live()
        self.bpctx = None  # the blocks' pctx, set by `blocks`

    # -- the model seam ---------------------------------------------------

    def prepare(self, model, params):
        """(the non-block leaves, the stacked block weights): ZeRO-3's
        `prepare` (the tail gathered whole, the block shards cast or
        quantized at rest), or at stages 0-2 the model's own stacking."""
        if self.g is not None:
            return self.g.z3.prepare(params, tail_whole=self.tail_whole)
        return params, model.stacked_compute_params(params)

    def blocks(self, model, x, stacked, dkeys, pctx=None):
        # the blocks see the rank's layout (its dropout frame) but not
        # the engine's gather: the executor gathers the layers itself
        self.bpctx = (None if pctx is None
                      else dataclasses.replace(pctx, gather=None))
        keys = list(stacked)
        vals = [stacked[k] for k in keys]
        grad_on = torch.is_grad_enabled() and any(
            v.requires_grad for v in vals + [x])
        y = _ScanFn.apply(self, keys, list(dkeys), grad_on, x, *vals)
        return y, None

    # -- gathers -------------------------------------------------------------

    def _layer_bytes(self, stacked) -> int:
        if self.g is not None:
            return self.g.layer_bytes(stacked)
        return sum(v[0].numel() * torch.empty((), dtype=(
            self.cd if k + "#scale" in stacked else v.dtype)).element_size()
            for k, v in stacked.items() if "#" not in k)

    def _issue(self, src, l: int):
        self.live.add(self._lb_bytes)
        if self.g is not None:
            return self.g.issue(src, l)
        return l

    def _finish(self, src, p) -> Dict[str, torch.Tensor]:
        if self.g is not None:
            return self.g.finish(src, p)
        out = {}
        for k, v in src.items():
            if "#" in k:
                continue
            s = src.get(k + "#scale")
            out[k] = (v[p] if s is None
                      else v[p].to(self.cd) * s[p].to(self.cd))
        return out

    def _advance(self, src, q) -> None:
        if self.g is not None:
            for p in q:
                self.g.advance(src, p)

    # -- forward -------------------------------------------------------------

    def forward(self, x, stacked, dkeys, grad_on):
        L = self.model.config.n_layer
        look = self.look
        self._lb_bytes = self._layer_bytes(stacked)
        src = self.g.begin(stacked) if self.g is not None else stacked
        q = deque(self._issue(src, l) for l in range(min(look, L)))
        # the backward's first gathers are issued where the forward's
        # lookahead runs past the last layer (JAX's clamped gathers)
        back = [L - 1 - j for j in range(min(look, L))] if grad_on else []
        stash = []
        for k in range(L):
            self._advance(src, q)
            j = k + look
            if j < L:
                q.append(self._issue(src, j))
            elif j - L < len(back):
                q.append(self._issue(src, back[j - L]))
            w = self._finish(src, q.popleft())
            if grad_on:
                stash.append(x)
            x = self.model._block(x, w, dkey=dkeys[k], pctx=self.bpctx)
            del w
            self.live.sub(self._lb_bytes)
        return x, (stash, src, q) if grad_on else None

    # -- backward ------------------------------------------------------------

    def backward(self, dy, stacked, dkeys, saved):
        stash, src, q = saved
        L = self.model.config.n_layer
        look = self.look
        grads = self._grad_buffers(stacked)
        lb = self.lb or 1
        if self.codec is not None:
            self.new_residual = [None] * (L // lb)
        if self.probe_on:
            self.probe_stats = torch.zeros(L, LAYER_PROBE_WIDTH,
                                           dtype=torch.float32,
                                           device=dy.device)
        bucket: Dict[int, Dict[str, torch.Tensor]] = {}
        inflight: Optional[tuple] = None
        dx = dy
        for k in reversed(range(L)):
            self._advance(src, q)
            if look:
                if k - look >= 0:
                    q.append(self._issue(src, k - look))
            else:
                q.append(self._issue(src, k))
            w = self._finish(src, q.popleft())
            with torch.enable_grad():
                xk = stash[k].detach().requires_grad_()
                wl = {n: t.detach().requires_grad_() for n, t in w.items()}
                y = self.model._block(xk, wl, dkey=dkeys[k],
                                      pctx=self.bpctx)
                if self.probe_on:
                    self.probe_stats[k] = torch.cat([_act_stats(y),
                                                     _act_stats(dx)])
                got = torch.autograd.grad(y, [xk, *wl.values()], dx)
            stash[k] = None
            del w, wl, y, xk
            self.live.sub(self._lb_bytes)
            dx = got[0]
            bucket[k] = dict(zip(self._names(stacked), got[1:]))
            del got
            if k % lb == 0:
                rel = self._release(stacked, bucket)
                bucket = {}
                if inflight is not None:
                    self._land(stacked, grads, inflight)
                inflight = rel
        if inflight is not None:
            self._land(stacked, grads, inflight)
        return dx, grads

    @staticmethod
    def _names(stacked) -> List[str]:
        return [k for k in stacked if "#" not in k]

    def _grad_buffers(self, stacked) -> Dict[str, torch.Tensor]:
        """Zero gradients for the Function's differentiable inputs: the
        compute-dtype rest tensors, and each fp8 weight's f32 master."""
        out = {}
        for k in self._names(stacked):
            key = k + "#master" if k + "#scale" in stacked else k
            out[key] = torch.zeros_like(stacked[key])
        return out

    # -- releases ------------------------------------------------------------

    def _pieces(self, stacked, layers: Dict[int, Dict[str, torch.Tensor]]):
        """Per weight of a release: (name, fp8?, [(layer, value)]), the
        value the collective moves — the compute-dtype dW (composed:
        unscaled by inv), the fp8 path's product or codes."""
        out = []
        for k in self._names(stacked):
            fp8 = k + "#scale" in stacked
            vals = []
            for l in sorted(layers):
                g = layers[l][k]
                if fp8:
                    s = stacked[k + "#scale"][l]
                    if self.mode == "composed":
                        c = e4m3_round(g * s.to(self.cd))
                        if self.inv is not None:
                            c = e4m3_round(c * self.inv)
                        g = to_codes(c)
                    elif self.g.hop is None:
                        g = g * s.to(self.cd)  # GatherFp8Fn's product
                elif self.mode == "composed" and self.inv is not None:
                    g = (g.float() * self.inv).to(g.dtype)
                vals.append((l, g))
            out.append((k, fp8, vals))
        return out

    def _release_codec(self, stacked, layers):
        """One bucket through the codec: {name: (lb, ...) f32 dW} — an
        fp8 weight's e4m3 cotangent of its codes, e4m3(dW * scale) —
        unscaled by inv, its residual slice, the reduce-scatter issued."""
        ls = sorted(layers)
        gf = {}
        for k in self._names(stacked):
            vals = []
            for l in ls:
                g = layers[l][k]
                if k + "#scale" in stacked:
                    g = e4m3_round(g * stacked[k + "#scale"][l].to(self.cd))
                vals.append(g.float())
            gf[k] = torch.stack(vals)
            if self.inv is not None:
                gf[k] = gf[k] * self.inv
        b, nb = ls[0] // self.lb, self.model.config.n_layer // self.lb
        res = None
        if self.residual is not None:
            bpad = bucket_layout(self.model.param_shapes(),
                                 self.model.config.n_layer, nb,
                                 self.codec.n, self.codec.block)["bucket_pad"]
            res = self.residual[b * bpad:(b + 1) * bpad]
        return ("codec", b, self.codec.start(gf, res, self.step, (b, nb)),
                ls)

    def _land_codec(self, stacked, grads, rel) -> None:
        """The bucket's mean (JAX: f32, the shard's part, the rest dtype;
        an fp8 weight's master through e4m3 and / scale)."""
        _, b, p, ls = rel
        red, nr = C.finish_grad_sync(p)
        if self.residual is not None:
            self.new_residual[b] = nr
        for k in self._names(stacked):
            fp8 = k + "#scale" in stacked
            for i, l in enumerate(ls):
                full = red[k][i]
                if self.g is not None:
                    leaf = self.g.z3.leaves["h." + k]
                    piece = full.reshape(-1)[leaf.lo:leaf.hi]
                    if fp8:
                        s = stacked[k + "#scale"][l].reshape(-1)[
                            leaf.cols(piece.device)]
                else:
                    piece = full
                    if fp8:
                        s = stacked[k + "#scale"][l]
                if fp8:
                    grads[k + "#master"][l] = e4m3_round(piece) / s
                else:
                    grads[k][l] = piece.to(grads[k].dtype)

    def _release(self, stacked, layers):
        """Issue one release's collectives (at most two: a SUM of the
        compute-dtype values, and under the composed fp8 gather the
        codes' exchange; or the codec's); returns what `_land` needs."""
        if self.codec is not None:
            return self._release_codec(stacked, layers)
        n, stage3 = self.n, self.g is not None
        works = []
        pieces = self._pieces(stacked, layers)
        for codes in (False, True):
            sel = [(k, fp8, vals) for k, fp8, vals in pieces
                   if (fp8 and self.mode == "composed") == codes]
            if not sel:
                continue
            spans = [(k, l, fp8) for k, fp8, vals in sel for l, _ in vals]
            if stage3:
                rows = []
                for k, _, vals in sel:
                    leaf = self.g.z3.leaves["h." + k]
                    for _, v in vals:
                        pad = v.new_zeros(n * leaf.s)
                        pad[:leaf.n] = v.reshape(-1)
                        rows.append(pad.view(n, leaf.s))
                buf = torch.cat(rows, dim=1)
                if codes:
                    work, out = f8_pmean_shard(buf, n, self.group,
                                               async_op=True)
                else:
                    out = buf.new_empty(buf.shape[1])
                    work = dist.reduce_scatter_tensor(
                        out, buf.reshape(-1), op=_SUM, group=self.group,
                        async_op=True)
            else:
                buf = torch.cat([v.reshape(-1) for _, _, vals in sel
                                 for _, v in vals])
                if codes:
                    work, out = f8_pmean_whole(buf, n, self.group,
                                               async_op=True)
                else:
                    out = buf
                    work = dist.all_reduce(buf, op=_SUM, group=self.group,
                                           async_op=True)
            works.append((work, out, buf, spans, codes))
        return works

    def _land(self, stacked, grads, works) -> None:
        """Wait for one release and write its results into the
        gradients: a compute-dtype rest tensor's rows, or an fp8 weight's
        master rows through the stacked cast's pullback (/ scale)."""
        if self.codec is not None:
            return self._land_codec(stacked, grads, works)
        n, stage3 = self.n, self.g is not None
        for work, out, _buf, spans, codes in works:
            work.wait()
            if codes:
                vals = f8_sum_mean(out, n)
            elif self.mode == "composed":
                vals = out / n
            else:
                vals = out
            off = 0
            for k, l, fp8 in spans:
                if stage3:
                    leaf = self.g.z3.leaves["h." + k]
                    piece = vals[off:off + leaf.s][:leaf.own]
                    off += leaf.s
                    if not fp8:
                        grads[k][l] = piece
                        continue
                    s = stacked[k + "#scale"][l].reshape(-1)[
                        leaf.cols(piece.device)]
                    if not codes:  # the prefetch lowering's pullbacks
                        piece = (e4m3_round(piece) if self.g.hop is None
                                 else e4m3_round(piece.float() * s))
                    grads[k + "#master"][l] = piece / s
                else:
                    shape = stacked[k][l].shape
                    piece = vals[off:off + shape.numel()].view(shape)
                    off += shape.numel()
                    if fp8:
                        grads[k + "#master"][l] = (
                            piece / stacked[k + "#scale"][l])
                    else:
                        grads[k][l] = piece
