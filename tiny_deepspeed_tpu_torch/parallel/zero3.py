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
  gathers move compute-dtype bytes (JAX's `stacked_compute_params`; a
  leaf the model keeps wider, MoE's router, in its `_stacked_dtype`) —
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
- `LayerGather` (the scheduled gathers of parallel/schedule.py, JAX
  `GatherPrefetchScan._gather` and `composed_step`'s `gather_k`): one
  layer's gathers issued asynchronously (`issue`) and completed later
  (`finish`), so a layer-ahead prefetch keeps them in flight while the
  layer before computes.  Three routes: flat (one all-gather over the
  data group, as `GatherFn`), the 2-hop gather (hop 1 over m
  consecutive ranks at the resting precision, the group's chunk
  dequantized once, hop 2 across the groups in the compute dtype; JAX
  schedule.py:580-700) and hpZ's (once a step, `begin` all-gathers each
  granule's compute-dtype replica of the block weights over the
  inter-granule group; every layer gather then runs over the
  intra-granule group and reorders the pieces into rank order, JAX's
  `unperm`).  The gathered weights equal `GatherFn` / `GatherFp8Fn`'s
  bit for bit on every route: the pieces are moved, and the fp8 codes
  dequantized by the same elementwise product.

Under tensor / expert parallelism (parallel/tensor.py) every leaf above
is the rank's TP / EP piece (`Zero3Gather`'s `shapes`): the data shards,
the gathers and the reduce-scatters work on the pieces over the data
group.  The fp8 scale of a piece cut on a reduced axis (a row-parallel
IN, an expert leaf's E) takes one more MAX, over that axis' group
(`models.gpt2.channel_amax`): JAX's scale is over the whole leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ..models.gpt2 import channel_amax, e4m3_round, fp8_scale

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
    gathers the model's forward calls (`pctx.gather`).  `shapes` are the
    leaves the rank shards (default the model's whole ones; under TP /
    EP the rank's pieces)."""

    def __init__(self, model, pctx, shapes=None):
        self.model, self.pctx = model, pctx
        self.cd = model.config.compute_dtype
        d, r = pctx.data_size, pctx.data_rank
        self.leaves: Dict[str, Leaf] = {}
        for name, shape in (shapes or model.param_shapes()).items():
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
        shard: (codes as uint8, scale (L, 1, ..., 1, out) — the absmax
        over every axis but the layer's and the out-channel's, an expert
        leaf's (E, IN) included), bit for bit JAX's codes and scales."""
        leaf = self.leaves["h." + name]
        v = shard.detach()
        col = leaf.cols(v.device).expand(self.n_layer, -1)
        amax = v.new_zeros(self.n_layer, leaf.shape[-1]).scatter_reduce_(
            1, col, v.abs(), "amax")
        dist.all_reduce(amax, op=_MAX, group=self.pctx.data_group)
        scale = fp8_scale(channel_amax(self.pctx, "h." + name, amax))
        codes = (v / torch.gather(scale, 1, col)).to(
            torch.float8_e4m3fn).view(torch.uint8)
        return codes, scale.view(self.n_layer, *[1] * (len(leaf.shape) - 1),
                                 -1)

    def prepare(self, shards: Dict[str, torch.Tensor], tail_whole=None):
        """Once per step: (the non-block leaves gathered whole, the block
        leaves stacked at rest — cast to the compute dtype, or e4m3 codes
        with their scale and master under the fp8 gather).  Given a dict
        `tail_whole`, the non-block leaves are gathered without a graph
        into new leaves that require grad, recorded there: their
        gradients stay whole and unreduced (the quantized tail release,
        JAX `qtail`)."""
        params, stacked = {}, {}
        for name, t in shards.items():
            if not name.startswith("h."):
                leaf = self.leaves[name]
                if tail_whole is not None:
                    with torch.no_grad():
                        w = gather_flat(t.detach(), leaf.n, leaf.s,
                                        self.pctx.data_group,
                                        self.pctx.data_size)
                    params[name] = tail_whole[name] = \
                        w.view(leaf.shape).requires_grad_()
                    continue
                params[name] = GatherFn.apply(t, leaf, self.pctx)
                continue
            short = name[2:]
            shape = (self.n_layer, *self.leaves[name].shape)
            if self.model._quant_eligible(short, shape):
                codes, scale = self._quantize(short, t)
                stacked.update({short: codes, short + "#scale": scale,
                                short + "#master": t})
            else:
                stacked[short] = t.to(self.model._stacked_dtype(short))
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


def _pad(t: torch.Tensor, s: int) -> torch.Tensor:
    t = t.reshape(-1)
    if t.numel() == s:
        return t.contiguous()
    return torch.cat([t, t.new_zeros(s - t.numel())])


class _Pending:
    """One layer's gathers in flight: per weight name its work handles,
    output buffers and route state."""

    def __init__(self, layer: int):
        self.layer = layer
        self.items: Dict[str, list] = {}


class LayerGather:
    """One layer's block weights gathered from the rank's resting shards
    (`Zero3Gather.prepare`'s stacked dict), issued ahead of their use.

    `hop` = (intra group, inter group, m) runs the 2-hop gather; `hpz` =
    (intra group, inter group, ici, n_gran) gathers within the granule
    from the replica `begin` builds.  `finish` returns {name: the
    layer's whole weight in the compute dtype}: fp8 codes dequantized,
    codes * scale, as `GatherFp8Fn`."""

    def __init__(self, z3: Zero3Gather, hop=None, hpz=None,
                 hpz_mode: str = "fp32"):
        self.z3, self.hop, self.hpz = z3, hop, hpz
        self.hpz_mode = hpz_mode
        self.cd = z3.cd
        self.group = z3.pctx.data_group
        self.n = z3.pctx.data_size

    @staticmethod
    def names(stacked) -> List[str]:
        return [k for k in stacked if "#" not in k]

    def layer_bytes(self, stacked) -> int:
        """The bytes of one layer's gathered weights (compute form)."""
        out = 0
        for k in self.names(stacked):
            leaf = self.z3.leaves["h." + k]
            dt = self.cd if k + "#scale" in stacked else stacked[k].dtype
            out += leaf.n * torch.empty((), dtype=dt).element_size()
        return out

    def begin(self, stacked):
        """The gather source for the step: the resting shards, or under
        hpZ each granule's replica — one all-gather a leaf over the
        inter-granule group, (L, n_gran, S) with slot g this rank's
        intra position's shard in granule g."""
        if self.hpz is None:
            return stacked
        _, inter, _, n_gran = self.hpz
        src = dict(stacked)
        if self.hpz_mode != "fp32":
            return self._begin_codec(stacked, src, inter, n_gran)
        for k in self.names(stacked):
            leaf = self.z3.leaves["h." + k]
            rest = stacked[k].detach()
            rows = rest.new_zeros(self.z3.n_layer, leaf.s)
            rows[:, :leaf.own] = rest
            out = rows.new_empty(n_gran * self.z3.n_layer * leaf.s)
            dist.all_gather_into_tensor(out, rows.reshape(-1), group=inter)
            src[k] = out.view(n_gran, self.z3.n_layer, leaf.s).transpose(
                0, 1).contiguous()
        return src

    def _begin_codec(self, stacked, src, inter, n_gran):
        """hpZ's rebuild through the codec (`hpz_comm`, JAX `build_sec`
        :1867-1920): every leaf's (L, S) rest rows in one blockwise
        payload, rounded to nearest, gathered as codes and scales over
        the inter-granule group and dequantized once (`comm.hpz_rebuild`).
        An fp8 gather's codes travel as their e4m3 values and come back
        as codes.  The replica feeds the forward only: the gradients
        reach the masters straight through."""
        from .comm import hpz_rebuild
        rows = {}
        for k in self.names(stacked):
            leaf = self.z3.leaves["h." + k]
            rest = stacked[k].detach()
            if k + "#scale" in stacked:
                rest = rest.view(torch.float8_e4m3fn).float()
            r = rest.new_zeros(self.z3.n_layer, leaf.s)
            r[:, :leaf.own] = rest
            rows[k] = r
        for k, v in hpz_rebuild(rows, self.hpz_mode, inter, n_gran).items():
            if k + "#scale" in stacked:
                v = e4m3_round(v).to(torch.float8_e4m3fn).view(torch.uint8)
            src[k] = v
        return src

    def issue(self, src, l: int) -> _Pending:
        """Start layer l's gathers (asynchronous).  Each item holds its
        work handle, output and input buffers until `finish`."""
        p = _Pending(l)
        for k in self.names(src):
            leaf = self.z3.leaves["h." + k]
            rest = src[k][l].detach()
            if self.hpz is not None:
                intra, _, ici, _ = self.hpz
                buf = rest.reshape(-1).contiguous()
                group, size = intra, ici
            elif self.hop is not None:
                intra, _, m = self.hop
                buf, group, size = _pad(rest, leaf.s), intra, m
            else:
                buf, group, size = _pad(rest, leaf.s), self.group, self.n
            out = buf.new_empty(size * buf.numel())
            w = dist.all_gather_into_tensor(out, buf, group=group,
                                            async_op=True)
            p.items[k] = [w, out, 1, buf]
        return p

    def _deq(self, src, k: str, l: int, codes: torch.Tensor,
             lo: int) -> torch.Tensor:
        """Codes (uint8) of the flat elements [lo, lo + len) of layer l's
        leaf k -> codes * scale in the compute dtype (`GatherFp8Fn`'s
        product, elementwise)."""
        leaf = self.z3.leaves["h." + k]
        scale = src[k + "#scale"][l].reshape(-1)
        cols = torch.arange(lo, lo + codes.numel(),
                            device=codes.device) % leaf.shape[-1]
        return (codes.view(torch.float8_e4m3fn).to(self.cd)
                * scale[cols].to(self.cd))

    def advance(self, src, p: _Pending) -> None:
        """The 2-hop gather's second hop: wait for hop 1, dequantize the
        group's chunk once, start hop 2 across the groups."""
        if self.hop is None:
            return
        intra, inter, m = self.hop
        for k, it in p.items.items():
            if it[2] != 1:
                continue
            work, out, _, _ = it
            work.wait()
            leaf = self.z3.leaves["h." + k]
            chunk = out
            if k + "#scale" in src:
                g = dist.get_rank(self.group) // m  # this rank's group
                chunk = self._deq(src, k, p.layer, out, g * m * leaf.s)
            out2 = chunk.new_empty(self.n * leaf.s)
            w2 = dist.all_gather_into_tensor(out2, chunk, group=inter,
                                             async_op=True)
            it[:] = [w2, out2, 2, chunk]

    def finish(self, src, p: _Pending) -> Dict[str, torch.Tensor]:
        """Wait for layer p.layer's gathers: {name: whole weight}."""
        self.advance(src, p)
        out = {}
        for k, (work, buf, stage, _) in p.items.items():
            work.wait()
            leaf = self.z3.leaves["h." + k]
            if self.hpz is not None:
                _, _, ici, n_gran = self.hpz
                buf = buf.view(ici, n_gran, leaf.s).transpose(0, 1).reshape(-1)
            flat = buf[:leaf.n]
            if k + "#scale" in src and stage != 2:
                scale = src[k + "#scale"][p.layer]
                out[k] = (flat.view(torch.float8_e4m3fn).view(leaf.shape)
                          .to(self.cd) * scale.to(self.cd))
            else:
                out[k] = flat.view(leaf.shape)
        return out
