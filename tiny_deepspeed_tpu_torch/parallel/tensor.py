# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Tensor and expert parallelism: the leaves' layout.

Counterpart of the JAX engines' "model" and "expert" mesh axes
(parallel/engine.py:455-478, :727-753 there).  In JAX a model lists its
placements (`tp_rules()`: {leaf: dim} over "model", `ep_rules()`: {leaf:
dim} over "expert"), the engine turns them into reserved dims of each
leaf's spec and GSPMD inserts the collectives.  Here the same tables cut
the leaves and Megatron's explicit collectives run in the model's
forward:

- `TPLayout(model, pctx)` checks the tables as JAX does (its exceptions
  and messages: the head count, every reserved dim, and the port's own
  kv-head refusal) and holds each leaf's `Cut`s.  `shard_leaf` cuts a
  rank's piece out of a whole leaf and `unshard` joins the pieces back
  into JAX's logical layout, bit for bit;
- GPT-2's fused `h.attn.qkv.w` (L, D, 3D) and `.b` (L, 3D) rest cut
  differently from JAX's physical shard.  JAX shards dim 2 as one
  contiguous block of 3D/tp columns and GSPMD reshards around the
  q / k / v split; a model rank here needs the q, k and v columns of its
  own heads.  So the cut has `blocks=3`: the dim is three blocks of D,
  each cut into tp pieces, and rank m holds piece m of each, side by side
  (its own heads' q | k | v).  AdamW's moments follow the leaf (they are
  elementwise).  `unshard` undoes it, so `gather_params`, the
  checkpoints' `load_params` and `convert` see JAX's (L, D, 3D);
- the collectives that join the pieces' products are Megatron's f and g,
  `copy_to` / `reduce_from` (ops/collectives.py), over the group's
  communicator on the context (`mesh.GroupReduce`);
- `count_once(pctx, name)`: whether this rank counts leaf `name` in a
  global sum over leaves (the grad clip's and the telemetry's norms).  A
  leaf cut over an axis is summed across that axis's group; a leaf
  replicated along an axis is counted by that axis's rank 0 only.

The vocab-parallel loss head is in ops/softmax_xent.py (`vocab=`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Cut:
    """One axis' cut of a leaf: dim `dim` over the `axis` group of `size`
    ranks.  `blocks` > 1 cuts each of that many equal blocks of the dim
    (GPT-2's q | k | v), rank i holding piece i of every block."""
    dim: int
    axis: str
    size: int
    blocks: int = 1


def _cut(t: torch.Tensor, c: Cut, i: int) -> torch.Tensor:
    n = t.shape[c.dim]
    seg = n // c.blocks
    piece = seg // c.size
    if c.blocks == 1:
        return t.narrow(c.dim, i * piece, piece)
    return torch.cat([t.narrow(c.dim, b * seg + i * piece, piece)
                      for b in range(c.blocks)], dim=c.dim)


def _join(pieces: List[torch.Tensor], c: Cut) -> torch.Tensor:
    if c.blocks == 1:
        return torch.cat(pieces, dim=c.dim)
    parts = [p.chunk(c.blocks, dim=c.dim) for p in pieces]
    return torch.cat([parts[i][b] for b in range(c.blocks)
                      for i in range(len(pieces))], dim=c.dim)


def shard_leaf(whole: torch.Tensor, cuts, coords: Dict[str, int]
               ) -> torch.Tensor:
    """The piece of `whole` at `coords` ({axis: rank along it}) under
    `cuts` (a view or a fresh tensor: clone it to keep it)."""
    t = whole
    for c in cuts:
        t = _cut(t, c, coords[c.axis])
    return t


def unshard(pieces: Dict[Tuple[int, ...], torch.Tensor], cuts
            ) -> torch.Tensor:
    """The whole leaf from its pieces, keyed by the tuple of each cut's
    rank (in `cuts`' order): JAX's logical layout.  The inverse of
    `shard_leaf`."""
    cuts = list(cuts)
    if not cuts:
        return pieces[()]
    last = cuts[-1]
    groups: Dict[Tuple[int, ...], List[torch.Tensor]] = {}
    for key in sorted(pieces):
        groups.setdefault(key[:-1], []).append(pieces[key])
    return unshard({k: _join(v, last) for k, v in groups.items()},
                   cuts[:-1])


class TPLayout:
    """The cuts of `model`'s leaves under a (model, expert) split of
    sizes (tp, ep), checked as the JAX engine checks them (:727-753), and
    a rank's coordinates on those axes.

    `cuts[name]` is the leaf's tuple of `Cut`s (empty: replicated);
    `shapes` the rank's local shapes; `shard(name, whole)` its piece."""

    def __init__(self, model, tp: int = 1, ep: int = 1,
                 model_rank: int = 0, expert_rank: int = 0):
        self.tp, self.ep = int(tp), int(ep)
        self.coords = {"model": int(model_rank), "expert": int(expert_rank)}
        whole = model.param_shapes()
        cfg = model.config
        if self.tp > 1 and cfg.n_head % self.tp:
            raise ValueError(f"n_head={cfg.n_head} not divisible by "
                             f"tensor-parallel axis size {self.tp}")
        blocks = model.tp_blocks()
        cuts: Dict[str, List[Cut]] = {n: [] for n in whole}
        for axis, size, rules in (("model", self.tp, "tp_rules"),
                                  ("expert", self.ep, "ep_rules")):
            if size == 1:
                continue
            for name, dim in getattr(model, rules, dict)().items():
                if name not in whole:  # JAX skips absent names (:744)
                    continue
                if whole[name][dim] % size:
                    raise ValueError(
                        f"{name} dim {dim} ({whole[name][dim]}) not "
                        f"divisible by {axis} axis size {size}")
                b = blocks.get(name, 1) if axis == "model" else 1
                cuts[name].append(Cut(dim, axis, size, b))
        kvh = getattr(cfg, "kv_heads", cfg.n_head)
        if self.tp > 1 and kvh % self.tp:
            # JAX's rules shard k.w's columns whenever they divide and
            # GSPMD regroups the heads; the port cuts whole kv heads
            raise ValueError(
                f"n_kv_head={kvh} not divisible by tensor-parallel axis "
                f"size {self.tp}: the port gives each model rank whole "
                f"K/V heads (ROADMAP.md, known differences)")
        self.cuts = {n: tuple(c) for n, c in cuts.items()}
        self.whole_shapes = {n: tuple(s) for n, s in whole.items()}
        self.shapes = {n: local_shape(s, self.cuts[n])
                       for n, s in self.whole_shapes.items()}

    def sharded(self, name: str) -> bool:
        return bool(self.cuts[name])

    def shard(self, name: str, whole: torch.Tensor,
              coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """The rank's piece of a whole leaf (or of an optimizer slot of
        it); `coords` overrides the rank's own coordinates."""
        return shard_leaf(whole, self.cuts[name], coords or self.coords)

    def plan(self) -> Dict[str, List[List]]:
        """The cuts as plain lists (what a checkpoint's layout records):
        {name: [[dim, axis, size, blocks], ...]} for every cut leaf."""
        return {n: [[c.dim, c.axis, c.size, c.blocks] for c in cs]
                for n, cs in self.cuts.items() if cs}


def local_shape(shape, cuts) -> Tuple[int, ...]:
    """A whole leaf's shape -> its piece's under `cuts`."""
    s = list(shape)
    for c in cuts:
        s[c.dim] //= c.size
    return tuple(s)


def cuts_from_plan(plan) -> Dict[str, Tuple[Cut, ...]]:
    """`TPLayout.plan()`'s lists back as `Cut`s."""
    return {n: tuple(Cut(int(d), a, int(s), int(b)) for d, a, s, b in cs)
            for n, cs in (plan or {}).items()}


def count_once(pctx, name: str) -> bool:
    """Whether this rank counts leaf `name` (its piece) in a global sum
    over leaves that is then SUMmed over the (model x expert) ranks: a
    leaf cut over an axis is counted on every rank of it (each holds a
    different piece), a leaf replicated along an axis only on that
    axis's rank 0."""
    tp = None if pctx is None else pctx.tp
    if tp is None:
        return True
    axes = {c.axis for c in tp.cuts[name]}
    return ((pctx.model_rank == 0 or "model" in axes)
            and (pctx.expert_rank == 0 or "expert" in axes))


def sum_comm(pctx):
    """The communicator that SUMs over every model and expert rank (the
    (model x expert) group, or the one axis that is split); None without
    TP / EP."""
    if pctx is None:
        return None
    return pctx.mxe_comm or pctx.model_comm or pctx.expert_comm
