# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The in-step collective schedule: ZeRO-3's gather prefetch, the 2-hop
gather and hpZ, and the bucketed gradient release.

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

Not ported yet (ROADMAP.md): the int8/fp8 grad codecs (`grad_comm`),
`grad_comm_groups`, error feedback, `grad_comm_tail`, `hpz_comm` other
than "fp32", the "auto" sizing and the telemetry probe slot.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.gpt2 import e4m3_round
from .comm import (bucket_layout, f8_pmean_shard, f8_pmean_whole,
                   f8_sum_mean, padded_scatter, to_codes)

_SUM = dist.ReduceOp.SUM
_LATER = "not ported yet (a later slice of the port, ROADMAP.md)"


class ScheduleConflictError(ValueError):
    """The refusal path for slot combinations the scheduler cannot emit;
    every message names the conflicting SLOT (JAX :78)."""


@dataclasses.dataclass(frozen=True)
class GatherSlot:
    """Per-layer weight gathers (ZeRO-3): `prefetch` gathered layers held
    live (1 = on demand), `groups` the 2-hop gather's inner size, `hpz`
    the gathers within a granule from its replica (JAX :91)."""
    prefetch: int = 1
    groups: Optional[int] = None
    hpz: bool = False
    hpz_mode: str = "fp32"

    def __post_init__(self):
        if self.hpz_mode != "fp32":
            raise ValueError(f"hpz_comm={self.hpz_mode!r}: {_LATER}")

    def describe(self) -> str:
        s = f"gather_prefetch={self.prefetch}"
        if self.groups:
            s += f"(2-hop inner={self.groups})"
        if self.hpz:
            s += "+hpz"
        return s


@dataclasses.dataclass(frozen=True)
class GradSlot:
    """Gradient releases: `buckets` layer buckets plus the non-block tail
    (JAX :116), in fp32 — the codecs are a later slice."""
    buckets: int = 1
    mode: str = "fp32"

    def __post_init__(self):
        if self.mode != "fp32":
            raise ValueError(f"grad_comm={self.mode!r}: {_LATER}")

    def describe(self) -> str:
        return f"grad_buckets={self.buckets},grad_comm={self.mode}"


@dataclasses.dataclass
class Schedule:
    """A validated slot composition and its lowering (JAX :857)."""
    gather: Optional[GatherSlot] = None
    grad: Optional[GradSlot] = None
    lowering: str = "plain"
    layout: Optional[dict] = None
    hpz_geom: Optional[tuple] = None

    @property
    def slots(self):
        return [s for s in (self.gather, self.grad) if s is not None]

    def describe(self) -> str:
        if not self.slots:
            return "plain"
        return "+".join(s.describe() for s in self.slots) + \
            f"@{self.lowering}"


# ---------------------------------------------------------------------------
# --sched spec parsing (JAX :177, the ported vocabulary)
# ---------------------------------------------------------------------------

_SPEC_INT = ("gather_prefetch", "gather_groups", "grad_buckets")
_SPEC_FP32 = ("grad_comm", "hpz_comm")
_SPEC_LATER = ("grad_comm_groups", "grad_comm_block", "grad_comm_tail",
               "pipe")


def parse_sched_spec(spec: str) -> Dict[str, Any]:
    """A `--sched` composition string -> engine kwargs, e.g.
    "gather_prefetch=2,grad_buckets=4,hpz" -> {"gather_prefetch": 2,
    "grad_buckets": 4, "hpz": True}.  `grad_comm` / `hpz_comm` take only
    "fp32"; the codecs, "auto", `health` and the pipe slot are refused by
    name (ROADMAP.md), an unknown key as JAX refuses it."""
    out: Dict[str, Any] = {}
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        if part == "hpz":
            out["hpz"] = True
            continue
        if part == "health":
            raise ValueError(f"--sched health (the telemetry probe slot): "
                             f"{_LATER}")
        if "=" not in part:
            raise ValueError(f"--sched element {part!r} is not "
                             "'key=value', 'health' or 'hpz'")
        key, val = (s.strip() for s in part.split("=", 1))
        if key in _SPEC_LATER or val == "auto" and (
                key in _SPEC_INT or key in _SPEC_FP32):
            raise ValueError(f"--sched {key}={val}: {_LATER}")
        if key in _SPEC_INT:
            out[key] = int(val)
        elif key in _SPEC_FP32:
            if val != "fp32":
                raise ValueError(f"--sched {key}={val}: {_LATER}")
            out[key] = val
        else:
            raise ValueError(f"unknown --sched key {key!r}")
    return out


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
                   grad_buckets: int = 1, gather_prefetch: int = 0,
                   gather_groups: Optional[int] = None, hpz: bool = False,
                   hpz_comm: str = "fp32", granule_of=None) -> Schedule:
    """Translate the knobs into slots, validate the composition once and
    pick the lowering, as JAX's does.  `granule_of` is a {rank: granule}
    map or a callable returning one (called only when hpZ's geometry is
    needed: the port's map is a collective over the hosts' names)."""
    n_layer = int(getattr(getattr(model, "config", None), "n_layer", 0)
                  or 0)
    gq = bool(getattr(getattr(model, "config", None), "gather_quant", None))
    if hpz_comm != "fp32" and not hpz:
        raise ValueError("hpz_comm quantizes the hpZ secondary rebuild; "
                         "it needs hpz=True")

    # ---- declare slots from the knobs --------------------------------------
    gather = None
    if hpz or gather_prefetch > 1:
        gather = GatherSlot(prefetch=max(int(gather_prefetch) or 0, 1),
                            groups=gather_groups, hpz=bool(hpz),
                            hpz_mode=str(hpz_comm))
    grad = None
    if grad_buckets > 1 or grad_comm != "fp32":
        grad = GradSlot(buckets=max(int(grad_buckets), 1), mode=grad_comm)
    # ZeRO-3 with a grad slot: the on-demand gather slot, implicitly
    if stage >= 3 and grad is not None and gather is None:
        gather = GatherSlot(prefetch=1)
    if gather is None and grad is None:
        return Schedule(lowering="plain")

    # ---- single-feature inert fallbacks (1-rank data axis) -----------------
    if n_shard <= 1:
        if grad is not None:
            warnings.warn(
                f"grad slot ({grad.describe()}) is inert on a 1-device "
                "data axis (there is no gradient collective); running "
                "the exact unscheduled path", stacklevel=3)
        if gather is not None:
            warnings.warn(
                f"gather slot ({gather.describe()}) is inert on a "
                "1-device data axis (there is no weight gather); running "
                "the on-demand path", stacklevel=3)
        return Schedule(lowering="plain")

    slots = [s for s in (gather, grad) if s is not None]
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
                        (grad, "grad_bucket_capable")):
            if s is not None and not getattr(model, flag, False):
                raise ScheduleConflictError(
                    f"{type(model).__name__} cannot run the "
                    f"{s.describe()} slot through the composed scan "
                    f"({flag}=False — e.g. the MoE scan carries an "
                    f"aux-loss accumulator the merged scan body does "
                    f"not thread)")

    # ---- slot-level validation ---------------------------------------------
    busy = [ax for ax in busy_axes if ax is not None]
    if grad is not None:
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
        gmap = granule_of() if callable(granule_of) else granule_of
        if gmap is None:
            raise ScheduleConflictError(
                "gather slot (hpz): no DCN granule map — the mesh spans "
                "a single slice/process (parallel/mesh.granule_map "
                "returned None) and no granule_of= override was given")
        geom = hpz_groups(gmap, n_shard)

    # ---- pick the lowering --------------------------------------------------
    layout = None
    if grad is not None and (grad.buckets > 1 or multi):
        layout = bucket_layout(model.param_shapes(), n_layer, grad.buckets)
    if multi:
        lowering = "composed"
    elif grad is not None:
        lowering = "bucket"
    else:
        lowering = "prefetch"
    return Schedule(gather=gather, grad=grad, lowering=lowering,
                    layout=layout, hpz_geom=geom)


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


class BucketRelease:
    """The bucket lowering's executor for one step (stages 0-2): each
    bucket's gradient all-reduced (stages 0-1) or reduce-scattered into
    the rank's flat shard (stage 2) from inside the backward, in the
    compute dtype, then divided by the rank count — JAX's compute-dtype
    `pmean` of each rank's own-batch gradient.

    `acc` ({name: f32 summed gradient of the earlier microbatches}) and
    `accum` fold accumulation in as JAX's final-microbatch taps do;
    `inv` unscales before the collective; `n_buckets` defaults to the
    engine's schedule's.  Every buffer a collective reads or writes is
    held until `finish` has waited on it."""

    def __init__(self, engine, acc=None, accum: int = 1, inv=None,
                 n_buckets: Optional[int] = None):
        self.eng = engine
        self.k = n_buckets or engine._schedule.layout["n_buckets"]
        self.lb = engine.model.config.n_layer // self.k
        self.acc, self.accum, self.inv = acc, accum, inv
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
        earlier microbatches' share over accum, unscaled, cast to the
        compute dtype, then issued asynchronously."""
        eng = self.eng
        sl = slice(b * self.lb, (b + 1) * self.lb)
        red = []
        for n, g in zip(self.names, grads):
            f = g.float()
            if self.acc is not None:
                f = (f + self.acc["h." + n][sl]) / self.accum
            if self.inv is not None:
                f = f * self.inv
            red.append(f.to(g.dtype))
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

    `live` counts the bytes of gathered layer weights it holds (issued
    and not yet dropped): at most `look + 1` layers' worth."""

    def __init__(self, engine, mode: str, look: int, lb: Optional[int],
                 gather=None):
        self.eng, self.mode, self.look, self.lb = engine, mode, look, lb
        self.g = gather  # zero3.LayerGather (stage 3) or None
        self.model = engine.model
        self.cd = self.model.config.compute_dtype
        self.n = engine.n_shard
        self.group = engine.pctx.data_group
        self.inv: Optional[float] = None
        self.live = _Live()

    # -- the model seam ---------------------------------------------------

    def prepare(self, model, params):
        """(the non-block leaves, the stacked block weights): ZeRO-3's
        `prepare` (the tail gathered whole, the block shards cast or
        quantized at rest), or at stages 0-2 the model's own stacking."""
        if self.g is not None:
            return self.g.z3.prepare(params)
        return params, model.stacked_compute_params(params)

    def blocks(self, model, x, stacked, dkeys, pctx=None):
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
            x = self.model._block(x, w, dkey=dkeys[k], pctx=None)
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
                y = self.model._block(xk, wl, dkey=dkeys[k], pctx=None)
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

    def _release(self, stacked, layers):
        """Issue one release's collectives (at most two: a SUM of the
        compute-dtype values, and under the composed fp8 gather the
        codes' exchange); returns what `_land` needs."""
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
