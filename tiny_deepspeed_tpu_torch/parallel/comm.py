# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Collective geometry of the in-step schedule, and its fp32 helpers.

Counterpart of the geometry half of `tiny_deepspeed_tpu/parallel/comm.py`
(`_hier_groups` :172, `bucket_layout` :340 without the codecs' padded
sizes) — the int8/fp8 gradient codecs are a later slice of the port
(ROADMAP.md).
The torch helpers below are what the schedule's executors
(parallel/schedule.py) issue:

- `new_groups(lists, rank)`: one `dist.new_group` per rank list, every
  list created on every rank in the same order (`new_group` is
  collective), returning the group this rank belongs to;
- `padded_scatter(flat, lo, hi, ...)`: a reduce-scatter of one
  contiguous range of a flat-sharded leaf whose ranks own unequal parts
  of it (a layer bucket of ZeRO-2's per-leaf shard) — each rank's part
  padded to the largest;
- `f8_sum_mean`: the mean over the data group of per-rank e4m3 values
  as XLA computes a `pmean` of a float8_e4m3fn array on the CPU: the
  all-reduce adds in rank order in f16, the sum rounds to e4m3, the
  division by the rank count rounds again (measured against JAX on the
  CPU: bit for bit at 2 and 4 ranks).  The codes cross the wire as
  uint8, one byte an element, through an all-to-all (`f8_pmean_shard`:
  each rank receives every rank's codes of its own shard) or, for a
  whole leaf, an all-gather (`f8_pmean_whole`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.gpt2 import e4m3_round

_SUM = dist.ReduceOp.SUM


def _hier_groups(n: int, inner: int):
    """(intra, inter) rank lists for n = G * inner consecutive ranks
    (JAX comm.py:172): intra the inner-sized groups of consecutive ranks
    (the 2-hop gather's hop 1), inter the same position across groups
    (hop 2)."""
    if inner < 1 or n % inner:
        raise ValueError(f"hierarchical inner group size {inner} must "
                         f"divide the axis size {n}")
    g_outer = n // inner
    intra = [[g * inner + j for j in range(inner)] for g in range(g_outer)]
    inter = [[g * inner + j for g in range(g_outer)] for j in range(inner)]
    return intra, inter


def bucket_layout(shapes, n_layer: int, n_buckets: int) -> dict:
    """Static geometry of the bucketed gradient release (JAX comm.py:340,
    fp32): the stacked "h.*" leaves chunked into `n_buckets` groups of
    n_layer / n_buckets consecutive layers, the non-block leaves the tail
    bucket.  `shapes` maps names to shapes (tuples, or anything with
    `.shape`)."""
    if n_buckets < 1:
        raise ValueError(f"grad_buckets must be >= 1, got {n_buckets}")
    if n_layer % n_buckets:
        raise ValueError(
            f"grad_buckets={n_buckets} must divide n_layer={n_layer} "
            "(equal layers per bucket is what keeps the buckets "
            "size-balanced and the scan body uniform)")

    def numel(s):
        return int(np.prod(getattr(s, "shape", s)))

    block_elems = sum(numel(s) for n, s in shapes.items()
                      if n.startswith("h."))
    tail_elems = sum(numel(s) for n, s in shapes.items()
                     if not n.startswith("h."))
    return {
        "n_buckets": n_buckets,
        "layers_per_bucket": n_layer // n_buckets,
        "bucket_elems": block_elems // n_buckets,
        "tail_elems": tail_elems,
        "tail_names": sorted(n for n in shapes if not n.startswith("h.")),
    }


def new_groups(lists: Sequence[Sequence[int]], rank: int,
               ranks_of=None):
    """Create one process group per rank list, in order, on every rank;
    return this rank's.  `ranks_of` maps a list's data-axis positions to
    global ranks (default: they are global ranks)."""
    mine = None
    for ranks in lists:
        glob = [ranks_of(r) if ranks_of else r for r in ranks]
        g = dist.new_group(glob)
        if rank in ranks:
            mine = g
    return mine


def padded_scatter(flat: torch.Tensor, lo: int, hi: int, s: int, n: int,
                   group, async_op: bool = False):
    """Reduce-scatter (SUM) the range [lo, hi) of a leaf flat-sharded over
    n ranks with shard size s (rank d owns [d*s, (d+1)*s)): `flat` holds
    the range's elements.  Returns (work or None, the input buffer, out,
    (a, b)) with out[:b - a] this rank's summed part [a, b) of the range
    once the work is done (a == b: the rank owns none of it); the caller
    holds both buffers until then."""
    parts = [(min(max(lo, d * s), hi), min(max(lo, (d + 1) * s), hi))
             for d in range(n)]
    width = max(b - a for a, b in parts)
    buf = flat.new_zeros(n, width)
    for d, (a, b) in enumerate(parts):
        if b > a:
            buf[d, :b - a] = flat[a - lo:b - lo]
    out = flat.new_empty(width)
    work = dist.reduce_scatter_tensor(out, buf.reshape(-1), op=_SUM,
                                      group=group, async_op=async_op)
    return work, buf, out, parts[dist.get_rank(group)]


def to_codes(v: torch.Tensor) -> torch.Tensor:
    """e4m3 values (held in f32; NaN where XLA's convert gave NaN) -> their
    uint8 codes."""
    return v.to(torch.float8_e4m3fn).view(torch.uint8)


def from_codes(c: torch.Tensor) -> torch.Tensor:
    return c.view(torch.float8_e4m3fn).float()


def f8_sum_mean(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) uint8 codes, one row a rank in rank order -> the e4m3
    pmean as XLA's CPU all-reduce computes it: f16 adds in rank order,
    rounded to e4m3, divided by n, rounded again (f32 e4m3 values)."""
    acc = from_codes(rows[0]).half()
    for r in range(1, n):
        acc = (acc.float() + from_codes(rows[r])).half()
    return e4m3_round(e4m3_round(acc.float()) / n)


def f8_pmean_shard(codes: torch.Tensor, n: int, group,
                   async_op: bool = False):
    """Every rank's (n, X) uint8 codes, row d the part rank d owns -> an
    all-to-all that hands each rank every rank's row of its own part.
    Returns (work or None, received (n, X)); `f8_sum_mean(received, n)`
    is this rank's part of the pmean."""
    out = torch.empty_like(codes)
    work = dist.all_to_all_single(out, codes.contiguous(), group=group,
                                  async_op=async_op)
    return work, out


def f8_pmean_whole(codes: torch.Tensor, n: int, group,
                   async_op: bool = False):
    """A whole leaf's uint8 codes -> (work or None, every rank's codes
    (n, *codes.shape)) for `f8_sum_mean`."""
    out = codes.new_empty(n * codes.numel())
    work = dist.all_gather_into_tensor(out, codes.reshape(-1).contiguous(),
                                       group=group, async_op=async_op)
    return work, out.view(n, *codes.shape)

