# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""ZeRO-3's weight gather: params sharded at rest, gathered on demand.

Under the JAX `Zero3` (parallel/engine.py:1553) the params rest sharded
(`_leaf_spec`, :106-150) and GSPMD inserts the gathers: the stacked
block leaves never shard their leading layer axis, so XLA gathers each
layer's weights inside the layer loop (and again in the remat
recompute), and the transposes of those gathers reduce-scatter the
gradients.  Here the same schedule is spelled out:

- the layout: a non-block leaf (`wte`, `wpe`, `ln_f.*`, an untied
  `lm_head.w`) rests as one flat shard, as Zero1/2's; each block leaf
  `h.*` rests per layer — layer l's slice, flattened, is flat-sharded,
  so a rank holds an (L, S_l) f32 master.  Shard size S = ceil(n / D)
  for n elements over D data ranks; data rank d owns [d*S, min((d+1)*S,
  n)), the tail rank's shard unpadded (`Leaf`);
- `GatherFn`: forward all-gathers a shard over the data group into the
  whole leaf; backward SUMs the leaf's cotangent over the seq group and
  reduce-scatters it over the data group into the shard's gradient;
- `Zero3Gather.prepare` (once per step, outside the layer loop and the
  remat): the non-block leaves gathered whole through `GatherFn` (f32),
  and the block shards cast to the compute dtype — so the per-layer
  gathers move compute-dtype bytes (JAX's `stacked_compute_params`) —
  or, under `gather_quant="fp8"`, quantized: each rank takes its slice's
  per-(layer, out-channel) absmax, an all-reduce MAX over the data group
  completes it (a rank holds only part of a channel's IN), and each rank
  quantizes its own shard to e4m3 codes;
- `Zero3Gather.layer` (inside each block's checkpoint, called by the
  model): gathers the layer's leaves, so the backward's recompute gathers
  them again and the selective remat policy never saves them (a gather
  is not a matmul).  Every rank issues the gathers in the same order (the
  model's leaf order; the recompute runs layer by layer on every rank),
  and a Function's backward runs once: one reduce-scatter per leaf and
  layer per backward.  The fp8 codes cross the wire as uint8 (NCCL and
  gloo have no float8 type) and are dequantized after the gather by
  `GatherFp8Fn`, whose backward is JAX's fp8 cotangent
  (`models.gpt2.fp8_cotangent`) taken on the reduce-scattered shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..models.gpt2 import e4m3_round, fp8_scale

_SUM, _MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def gather_flat(shard: torch.Tensor, n: int, s: int, group,
                size: int) -> torch.Tensor:
    """Every rank's flat shard (size s, or fewer for the tail) -> the
    whole flat leaf of n elements (one all-gather over `group`)."""
    buf = shard.reshape(-1)
    if buf.numel() != s:  # the unpadded tail shard (or an empty one)
        buf = torch.cat([buf, buf.new_zeros(s - buf.numel())])
    out = buf.new_empty(s * size)
    dist.all_gather_into_tensor(out, buf.contiguous(), group=group)
    return out[:n]


def scatter_flat(flat: torch.Tensor, n: int, s: int, own: int, group,
                 size: int, seq_group=None) -> torch.Tensor:
    """A whole flat leaf's gradient share -> the rank's shard of its sum:
    SUM over `seq_group` when given, then reduce-scatter over `group`.
    `flat` itself is never written (the seq SUM works on a copy)."""
    buf = flat.reshape(-1)
    if buf.numel() != s * size or seq_group is not None:
        buf = flat.new_zeros(s * size)
        buf[:n] = flat.reshape(-1)
    if seq_group is not None:
        dist.all_reduce(buf, op=_SUM, group=seq_group)
    out = buf.new_empty(s)
    dist.reduce_scatter_tensor(out, buf, op=_SUM, group=group)
    return out[:own]


def _scatter(g, leaf, pctx):
    return scatter_flat(g, leaf.n, leaf.s, leaf.own, pctx.data_group,
                        pctx.data_size, pctx.seq_group)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """The flat shard layout of one leaf (a block leaf: of one layer)."""
    shape: Tuple[int, ...]  # the whole leaf's (a block leaf: one layer's)
    n: int                  # its element count
    s: int                  # shard size, ceil(n / D)
    lo: int                 # this rank's elements [lo, hi)
    hi: int

    @property
    def own(self) -> int:
        return self.hi - self.lo

    def cols(self, device) -> torch.Tensor:
        """The out-channel (last axis) of each of this rank's elements."""
        return torch.arange(self.lo, self.hi, device=device) % self.shape[-1]


class GatherFn(torch.autograd.Function):
    """shard -> the whole leaf (forward: all-gather over the data group);
    the gradient: SUM over seq, reduce-scatter over data."""

    @staticmethod
    def forward(ctx, shard, leaf: Leaf, pctx):
        ctx.leaf, ctx.pctx = leaf, pctx
        return gather_flat(shard, leaf.n, leaf.s, pctx.data_group,
                           pctx.data_size).view(leaf.shape)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.leaf, ctx.pctx), None, None


class GatherFp8Fn(torch.autograd.Function):
    """One layer's fp8 block weight: the rank's e4m3 codes (a uint8 view)
    gathered over the data group, then dequantized, codes * scale in the
    compute dtype (JAX `_bw`).  `master` (the f32 master shard) is not
    read; it takes the gradient: the codes' cotangent g * scale (compute
    dtype) reduced as `GatherFn`'s, then rounded to e4m3 and divided by
    each shard element's channel scale (`models.gpt2.fp8_cotangent`)."""

    @staticmethod
    def forward(ctx, master, codes, scale, leaf: Leaf, pctx, cd):
        ctx.save_for_backward(scale)
        ctx.leaf, ctx.pctx, ctx.cd = leaf, pctx, cd
        w = gather_flat(codes, leaf.n, leaf.s, pctx.data_group,
                        pctx.data_size)
        return (w.view(torch.float8_e4m3fn).view(leaf.shape).to(cd)
                * scale.to(cd))

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        leaf = ctx.leaf
        gc = _scatter(g * scale.to(ctx.cd), leaf, ctx.pctx)
        return (e4m3_round(gc) / scale.reshape(-1)[leaf.cols(gc.device)],
                None, None, None, None, None)


class Zero3Gather:
    """The rank's ZeRO-3 layout of `model`'s params under `pctx` and the
    gathers the model's forward calls (`pctx.gather`)."""

    def __init__(self, model, pctx):
        self.model, self.pctx = model, pctx
        self.cd = model.config.compute_dtype
        d, r = pctx.data_size, pctx.data_rank
        self.leaves: Dict[str, Leaf] = {}
        for name, shape in model.param_shapes().items():
            shape = tuple(shape[1:]) if name.startswith("h.") else tuple(
                shape)
            n = math.prod(shape)
            s = -(-n // d)
            self.leaves[name] = Leaf(shape, n, s, min(r * s, n),
                                     min((r + 1) * s, n))
        self.n_layer = model.config.n_layer

    # -- layout ------------------------------------------------------------

    def shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """The rank's shard of a whole leaf (a view): flat (own,), or
        (L, own) for a block leaf."""
        leaf = self.leaves[name]
        if name.startswith("h."):
            return whole.reshape(self.n_layer, -1)[:, leaf.lo:leaf.hi]
        return whole.reshape(-1)[leaf.lo:leaf.hi]

    @torch.no_grad()
    def whole(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """Every data rank's shard of `name` (or of an optimizer slot of
        it) -> the whole leaf, without a graph."""
        leaf = self.leaves[name]
        p = self.pctx
        if not name.startswith("h."):
            return gather_flat(shard, leaf.n, leaf.s, p.data_group,
                               p.data_size).view(leaf.shape)
        rows = shard.new_zeros(self.n_layer, leaf.s)
        rows[:, :leaf.own] = shard
        out = rows.new_empty(p.data_size * self.n_layer * leaf.s)
        dist.all_gather_into_tensor(out, rows.reshape(-1),
                                    group=p.data_group)
        flat = out.view(p.data_size, self.n_layer, leaf.s).transpose(
            0, 1).reshape(self.n_layer, -1)[:, :leaf.n]
        return flat.reshape(self.n_layer, *leaf.shape)

    # -- the step's gathers ------------------------------------------------

    def _quantize(self, name: str, shard: torch.Tensor):
        """The fp8 gather's rest form of one block weight's (L, own) f32
        shard: (codes as uint8, scale (L, 1, out)), bit for bit JAX's
        codes and scales."""
        leaf = self.leaves["h." + name]
        v = shard.detach()
        col = leaf.cols(v.device).expand(self.n_layer, -1)
        amax = v.new_zeros(self.n_layer, leaf.shape[-1]).scatter_reduce_(
            1, col, v.abs(), "amax")
        dist.all_reduce(amax, op=_MAX, group=self.pctx.data_group)
        scale = fp8_scale(amax)[:, None, :]
        codes = (v / torch.gather(scale[:, 0, :], 1, col)).to(
            torch.float8_e4m3fn).view(torch.uint8)
        return codes, scale

    def prepare(self, shards: Dict[str, torch.Tensor]):
        """Once per step: (the non-block leaves gathered whole, the block
        leaves stacked at rest — cast to the compute dtype, or e4m3 codes
        with their scale and master under the fp8 gather)."""
        params, stacked = {}, {}
        for name, t in shards.items():
            if not name.startswith("h."):
                params[name] = GatherFn.apply(t, self.leaves[name],
                                              self.pctx)
                continue
            short = name[2:]
            shape = (self.n_layer, *self.leaves[name].shape)
            if self.model._quant_eligible(short, shape):
                codes, scale = self._quantize(short, t)
                stacked.update({short: codes, short + "#scale": scale,
                                short + "#master": t})
            else:
                stacked[short] = t.to(self.cd)
        return params, stacked

    def layer(self, bp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One layer's shards (its slice of `prepare`'s stacked dict) ->
        its whole weights in the compute dtype, fp8 ones dequantized."""
        out = {}
        for name in bp:
            if "#" in name:
                continue
            leaf = self.leaves["h." + name]
            if name + "#scale" in bp:
                out[name] = GatherFp8Fn.apply(
                    bp[name + "#master"], bp[name], bp[name + "#scale"],
                    leaf, self.pctx, self.cd)
            else:
                out[name] = GatherFn.apply(bp[name], leaf, self.pctx)
        return out
