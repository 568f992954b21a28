# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Collective codecs and geometry of the in-step schedule, and its fp32
helpers.

Counterpart of `tiny_deepspeed_tpu/parallel/comm.py`: the int8/fp8
gradient codecs (ZeRO++'s qgZ: `quantized_reduce_scatter` :209,
`quantized_all_gather` :253, `quantized_grad_sync` :270), the 2-hop
groups (`_hier_groups` :172, `piece_owner` :190), the bucket layout with
its padded sizes (`bucket_layout` :340) and the ring wire models
(:386-457).  The port keeps its own copy of the codec: the blockwise
quantizer is `ops/quant.py` (the Triton kernel on the card, its plain
version on the CPU), the rest is plain PyTorch over `torch.distributed`,
as JAX leaves it to XLA.

The codec (JAX's schedule, one rank's view; E the flat length, n ranks):

1. the local gradient tree flattened in sorted-name order (JAX's
   `tree.leaves` of a dict), cast to f32 and zero-padded to
   `padded_size(E, n, block)`;
2. error feedback: err = flat + residual, quantized ONCE; the new
   residual is err - dequant(codes), its non-finite values scrubbed;
3. the reduce-scatter as an all-to-all of the codes (fp8 as uint8 on the
   wire) and of the scales, then each row dequantized and the rows summed
   in rank order; under the 2-hop schedule (`inner`) hop 1 runs in codes
   within the intra groups, hop 2 in bf16 partial sums across the inter
   groups;
4. the mean, the chunk re-quantized and all-gathered, the rows
   dequantized (and re-ordered by `piece_owner` after two hops), the
   leaves cut back out in their dtypes.

int8 rounds stochastically: a dither U(-1/2, 1/2) is added before the
round.  Its draw is `draw_dither(step, rank, site, hop, n, device)`, one
module-level function (the tests hand it JAX's draws); `SyncKey` names a
sync's stream.  fp8 and the hpZ rebuild take no dither.

`start_grad_sync` / `finish_grad_sync` split one sync at its
reduce-scatter so an executor can keep several in flight: the start
quantizes and issues the all-to-alls asynchronously, holding every
buffer they read or write; the finish waits, sums, and runs the
all-gather.

The fp32 helpers the executors (parallel/schedule.py) issue:

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

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import rng as prng
from ..models.gpt2 import e4m3_round
from ..ops.quant import quantize_blockwise

_SUM = dist.ReduceOp.SUM

GRAD_COMM_MODES = ("fp32", "int8", "fp8")
DEFAULT_BLOCK = 256
# the stochastic-rounding stream's root key (JAX PRNGKey(0x6C51))
QKEY = 0x6C51


def padded_size(n_elems: int, n_dev: int, block: int = DEFAULT_BLOCK) -> int:
    """Flat gradient length after padding (JAX :72): the smallest
    multiple of n_dev * block >= n_elems, so every hop's split is
    block-aligned."""
    unit = n_dev * block
    return max(unit, ((n_elems + unit - 1) // unit) * unit)


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


def bucket_layout(shapes, n_layer: int, n_buckets: int,
                  n_dev: Optional[int] = None,
                  block: int = DEFAULT_BLOCK) -> dict:
    """Static geometry of the bucketed gradient release (JAX comm.py:340):
    the stacked "h.*" leaves chunked into `n_buckets` groups of
    n_layer / n_buckets consecutive layers, the non-block leaves the tail
    bucket.  `shapes` maps names to shapes (tuples, or anything with
    `.shape`).  Given `n_dev`, also the codecs' padded sizes: a bucket's
    and the tail's flat length padded for `n_dev` ranks (`bucket_pad`,
    `tail_pad`) and the error-feedback residual row's length, laid out
    [bucket 0 | ... | bucket K-1 | tail] (`residual_len`)."""
    if n_buckets < 1:
        raise ValueError(f"grad_buckets must be >= 1, got {n_buckets}")
    if n_layer % n_buckets:
        raise ValueError(
            f"grad_buckets={n_buckets} must divide n_layer={n_layer} "
            "(equal layers per bucket is what keeps the buckets "
            "size-balanced and the scan body uniform)")
    block_elems = sum(numel(s) for n, s in shapes.items()
                      if n.startswith("h."))
    tail_elems = sum(numel(s) for n, s in shapes.items()
                     if not n.startswith("h."))
    per_bucket = block_elems // n_buckets
    out = {
        "n_buckets": n_buckets,
        "layers_per_bucket": n_layer // n_buckets,
        "bucket_elems": per_bucket,
        "tail_elems": tail_elems,
        "tail_names": sorted(n for n in shapes if not n.startswith("h.")),
    }
    if n_dev is not None:
        bucket_pad = padded_size(per_bucket, n_dev, block)
        tail_pad = padded_size(tail_elems, n_dev, block) if tail_elems \
            else 0
        out.update(bucket_pad=bucket_pad, tail_pad=tail_pad,
                   residual_len=n_buckets * bucket_pad + tail_pad)
    return out


def numel(s) -> int:
    """Elements of a shape (a tuple, or anything with `.shape`)."""
    return int(np.prod(getattr(s, "shape", s)))


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



# ---------------------------------------------------------------------------
# the grad-comm codecs (JAX :88-337)
# ---------------------------------------------------------------------------

def _quant_rows(parts: torch.Tensor, mode: str, block: int, dither=None):
    """(k, r) f32 rows (r % block == 0) -> (codes (k, r), scales
    (k, r / block)) (JAX :132).  Blocks never straddle rows, so row-wise
    quantization is flat quantization of the concatenation."""
    k, r = parts.shape
    q, s = quantize_blockwise(parts.reshape(-1), mode, block, dither)
    return q.view(k, r), s.view(k, r // block)


def _dequant_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(k, r) codes and (k, nb) scales -> (k, r) f32 (JAX :141)."""
    k, r = q.shape
    nb = s.shape[1]
    return (q.float().view(k, nb, r // nb) * s[:, :, None]).view(k, r)


def as_wire(q: torch.Tensor) -> torch.Tensor:
    """fp8 codes cross the wire as uint8 (JAX :150: one byte an element
    on every backend); int8 codes pass through."""
    if q.dtype == torch.float8_e4m3fn:
        return q.view(torch.uint8)
    return q


def from_wire(q: torch.Tensor, mode: str) -> torch.Tensor:
    """Undo `as_wire` after the collective (JAX :161)."""
    if mode == "fp8" and q.dtype == torch.uint8:
        return q.view(torch.float8_e4m3fn)
    return q


def piece_owner(n: int, inner: Optional[int]) -> np.ndarray:
    """owner[p] = the rank holding canonical piece p after the
    reduce-scatter (JAX :190).  Flat: owner[p] = p.  2-hop: rank r =
    (gid, lid) ends with sub-piece gid of part lid, i.e. piece p =
    lid * G + gid lives on rank gid * inner + lid."""
    if not inner or inner in (1, n):
        return np.arange(n)
    if n % inner:
        raise ValueError(f"hierarchical inner group size {inner} must "
                         f"divide the axis size {n}")
    g_outer = n // inner
    p = np.arange(n)
    gid, lid = p % g_outer, p // g_outer
    return gid * inner + lid


class SyncKey(NamedTuple):
    """One sync's stochastic-rounding stream: the optimizer step, the
    data rank and the site — None for the monolithic sync, (b, K) for
    bucket b of K (b == K: the tail), as JAX splits its key K + 1 ways
    (schedule.py:1484-1493)."""
    step: int
    rank: int
    site: Optional[Tuple[int, int]] = None


def draw_dither(step: int, rank: int, site, hop: str, n: int,
                device) -> torch.Tensor:
    """The int8 dither of one quantize: U(-1/2, 1/2) f32 of length n on
    `device`.  The key mirrors JAX's tree (schedule.py:1324-1343,
    comm.py:302-304): fold_in(fold_in(QKEY, step), rank), split K + 1 ways
    at a bucket site, then split in two for the reduce-scatter ("rs") and
    the all-gather ("ag"); a `torch.Generator` on `device` seeded with it
    draws the numbers (rng.py: the bits differ from JAX's)."""
    key = prng.fold_in(prng.fold_in(QKEY, step), rank)
    if site is not None:
        b, k = site
        key = prng.split(key, k + 1)[b]
    key = prng.split(key, 2)[0 if hop == "rs" else 1]
    g = torch.Generator(device=device).manual_seed(key)
    return torch.rand(n, generator=g, device=device) - 0.5


def _dither(key: Optional[SyncKey], mode: str, hop: str, n: int, device):
    if key is None or mode != "int8":
        return None
    return draw_dither(key.step, key.rank, key.site, hop, n, device)


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """The rows of (k, r) summed in row (rank) order, as XLA's reduce."""
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = acc + rows[i]
    return acc


def _a2a(x: torch.Tensor, group, async_op: bool):
    """all_to_all_single of x's rows over `group`: (work, received)."""
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x.contiguous(), group=group,
                                  async_op=async_op)
    return work, out


class PendingSync:
    """One sync between `start_grad_sync` and `finish_grad_sync`: the
    reduce-scatter's work handles and every buffer they read or write,
    the new residual, and what the finish needs to cut the leaves back
    out."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def quantized_reduce_scatter(flat, group, n: int, mode: str, *,
                             block: int = DEFAULT_BLOCK, dither=None,
                             inner: Optional[int] = None, hops=None,
                             pre_q: Optional[Tuple] = None):
    """Sum `flat` ((E,) f32 local, E % (n * block) == 0) over `group` (n
    ranks); returns this rank's 1/n chunk of the sum, in the canonical
    piece order of `piece_owner(n, inner)` (JAX :209).  `pre_q` = (codes,
    scales) of `flat` quantized already; else it is quantized here with
    `dither`.  `inner` (with `hops` = (intra group, inter group)) runs
    the 2-hop schedule."""
    if pre_q is None:
        pre_q = quantize_blockwise(flat, mode, block, dither)
    p = _rs_start(pre_q, group, n, mode, inner, hops)
    return _rs_finish(p, mode)


def _rs_start(pre_q, group, n: int, mode: str, inner, hops):
    q, s = pre_q
    e = q.numel()
    two = bool(inner) and inner not in (1, n)
    k = inner if two else n
    parts = as_wire(q).view(k, e // k)
    srows = s.reshape(k, -1)
    g = hops[0] if two else group
    w1, got_q = _a2a(parts, g, True)
    w2, got_s = _a2a(srows, g, True)
    return PendingSync(works=[w1, w2], sent=(parts, srows, q, s),
                       got=(got_q, got_s), two=two, n=n, inner=inner,
                       hops=hops)


def _rs_finish(p: PendingSync, mode: str) -> torch.Tensor:
    for w in p.works:
        w.wait()
    got_q, got_s = p.got
    part = _sum_rows(_dequant_rows(from_wire(got_q, mode), got_s))
    p.sent = p.got = None
    if not p.two:
        return part
    # hop 2: the partial sums in bf16 across the groups (JAX :246-250);
    # bf16 crosses as its two bytes (uint8), which every backend moves
    g_outer = p.n // p.inner
    sub = part.view(g_outer, -1).to(torch.bfloat16).view(torch.uint8)
    _, got = _a2a(sub, p.hops[1], False)
    return _sum_rows(got.view(torch.bfloat16).float())


def quantized_all_gather(chunk, group, n: int, mode: str, *,
                         block: int = DEFAULT_BLOCK, dither=None,
                         inner: Optional[int] = None) -> torch.Tensor:
    """The reduced chunks all-gathered back to the whole flat vector at
    `mode` precision (JAX :253): rows in rank order, re-ordered by
    `piece_owner` after two hops."""
    q, s = quantize_blockwise(chunk, mode, block, dither)
    wire = as_wire(q).contiguous()
    rows = wire.new_empty(n * wire.numel())
    dist.all_gather_into_tensor(rows, wire, group=group)
    srows = s.new_empty(n * s.numel())
    dist.all_gather_into_tensor(srows, s.reshape(-1).contiguous(),
                                group=group)
    vals = _dequant_rows(from_wire(rows.view(n, -1), mode),
                         srows.view(n, -1))
    owner = piece_owner(n, inner)
    if not np.array_equal(owner, np.arange(n)):
        vals = vals[torch.as_tensor(owner, device=vals.device)]
    return vals.reshape(-1)


def start_grad_sync(grads: Dict[str, torch.Tensor],
                    residual: Optional[torch.Tensor], group, n: int,
                    mode: str, *, block: int = DEFAULT_BLOCK,
                    key: Optional[SyncKey] = None,
                    inner: Optional[int] = None, hops=None) -> PendingSync:
    """The first half of `quantized_grad_sync`: flatten, error feedback,
    quantize once, issue the reduce-scatter's all-to-alls (asynchronous).
    The returned `PendingSync` holds every buffer in flight."""
    names = sorted(grads)
    leaves = [grads[k] for k in names]
    sizes = [t.numel() for t in leaves]
    total = sum(sizes)
    e_pad = padded_size(total, n, block)
    dev = leaves[0].device
    flat = torch.cat([t.reshape(-1).float() for t in leaves]
                     + ([torch.zeros(e_pad - total, device=dev)]
                        if e_pad > total else []))
    d = _dither(key, mode, "rs", e_pad, dev)
    new_residual = None
    if residual is not None:
        err = flat + residual
        q, s = quantize_blockwise(err, mode, block, d)
        new_residual = err - (q.float().view(s.shape[0], -1) * s).view(-1)
        # a non-finite local grad (an overflowing fp16 step) must not
        # poison the carried error: only the residual is scrubbed
        new_residual = torch.where(torch.isfinite(new_residual),
                                   new_residual, 0.0)
        del err
    else:
        q, s = quantize_blockwise(flat, mode, block, d)
    del flat, d
    p = _rs_start((q, s), group, n, mode, inner, hops)
    p.__dict__.update(names=names, shapes=[t.shape for t in leaves],
                      dtypes=[t.dtype for t in leaves], sizes=sizes,
                      residual=new_residual, group=group, mode=mode,
                      block=block, key=key)
    return p


def finish_grad_sync(p: PendingSync, mean: bool = True):
    """The second half: wait for the reduce-scatter, sum, take the mean,
    re-quantize and all-gather.  Returns ({name: reduced leaf in its
    dtype}, the new residual or None)."""
    chunk = _rs_finish(p, p.mode)
    if mean:
        chunk = chunk / torch.tensor(float(p.n), device=chunk.device)
    d = _dither(p.key, p.mode, "ag", chunk.numel(), chunk.device)
    out = quantized_all_gather(chunk, p.group, p.n, p.mode, block=p.block,
                               dither=d, inner=p.inner)
    del chunk, d
    red, off = {}, 0
    for k, shape, dt, sz in zip(p.names, p.shapes, p.dtypes, p.sizes):
        red[k] = out[off:off + sz].view(shape).to(dt)
        off += sz
    return red, p.residual


def quantized_grad_sync(grads: Dict[str, torch.Tensor],
                        residual: Optional[torch.Tensor], group, n: int,
                        mode: str, *, block: int = DEFAULT_BLOCK,
                        key: Optional[SyncKey] = None,
                        inner: Optional[int] = None, hops=None,
                        mean: bool = True):
    """Error-feedback quantized all-reduce of a local gradient dict over
    `group` (n ranks) (JAX :270): ({name: the mean in the leaf's dtype},
    the new flat residual or None).  `residual` is this rank's flat
    (padded_size,) f32 error carried from the last sync, or None (error
    feedback off); `key` the int8 dither's stream; `inner` with `hops` =
    (intra group, inter group) the 2-hop schedule."""
    return finish_grad_sync(
        start_grad_sync(grads, residual, group, n, mode, block=block,
                        key=key, inner=inner, hops=hops), mean)


# ---------------------------------------------------------------------------
# the hpZ rebuild codec (qwZ; JAX schedule.py build_sec :1867-1920)
# ---------------------------------------------------------------------------

def hpz_rebuild(rows: Dict[str, torch.Tensor], mode: str, inter,
                n_gran: int) -> Dict[str, torch.Tensor]:
    """hpZ's secondary rebuild through the codec: each leaf's (L, S) rest
    rows (this rank's shards, padded to S) concatenated in sorted-name
    order as one f32 payload, zero-padded to a whole block, quantized to
    nearest (no dither: no error feedback loop to make it pay), codes and
    scales all-gathered over the inter-granule group, dequantized once
    and cut back per leaf: {name: (L, n_gran, S) in the leaf's dtype},
    slot g granule g's shard.  One launch of the quantizer a step."""
    names = sorted(rows)
    sizes = [rows[k].numel() for k in names]
    flat = torch.cat([rows[k].reshape(-1).float() for k in names])
    pad = -flat.numel() % DEFAULT_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = quantize_blockwise(flat, mode, DEFAULT_BLOCK)
    wire = as_wire(q)
    got_q = wire.new_empty(n_gran * wire.numel())
    dist.all_gather_into_tensor(got_q, wire, group=inter)
    got_s = s.new_empty(n_gran * s.numel())
    dist.all_gather_into_tensor(got_s, s.reshape(-1).contiguous(),
                                group=inter)
    vals = _dequant_rows(from_wire(got_q.view(n_gran, -1), mode),
                         got_s.view(n_gran, -1))
    out, off = {}, 0
    for k, sz in zip(names, sizes):
        L, width = rows[k].shape
        seg = vals[:, off:off + sz].reshape(n_gran, L, width)
        out[k] = seg.transpose(0, 1).to(rows[k].dtype).contiguous()
        off += sz
    return out


# ---------------------------------------------------------------------------
# wire models (JAX :386-457)
# ---------------------------------------------------------------------------

def modeled_gather_wire_bytes(block_rest_bytes: int, block_cd_bytes: int,
                              n: int, inner: Optional[int] = None) -> float:
    """Ring-model per-device wire bytes of one full-stack weight gather
    (JAX :386): flat, the resting payload * (n-1)/n; 2-hop, hop 1's
    rest * (inner-1)/n plus hop 2's compute dtype * (g-1)/g."""
    if n <= 1:
        return 0.0
    if not inner or inner in (1, n):
        return block_rest_bytes * (n - 1) / n
    g_outer = n // inner
    return (block_rest_bytes * (inner - 1) / n
            + block_cd_bytes * (g_outer - 1) / g_outer)


def modeled_wire_bytes(n_elems: int, n: int, mode: str, *,
                       block: int = DEFAULT_BLOCK,
                       inner: Optional[int] = None) -> dict:
    """Ring-model per-device wire bytes of one quantized grad sync beside
    the fp32 all-reduce's (JAX :415): all-to-all and all-gather both move
    payload * (n-1)/n; 1-byte codes plus 4-byte scales a block; the
    2-hop's second hop bf16."""
    e = padded_size(n_elems, n, block)
    scale_b = e // block * 4
    qpay = e * 1 + scale_b
    if not inner or inner in (1, n):
        rs = qpay * (n - 1) / n
    else:
        g_outer = n // inner
        rs = (qpay * (inner - 1) / inner
              + 2 * (e // inner) * (g_outer - 1) / g_outer)
    ag = qpay * (n - 1) / n
    return {
        "mode": mode,
        "elems_padded": e,
        "quant_wire_bytes": float(rs + ag),
        "fp32_allreduce_wire_bytes": float(2 * 4 * n_elems * (n - 1) / n)
        if n > 1 else 0.0,
    }


def modeled_hpz_rebuild_bytes(shard_bytes: int, shard_elems: int,
                              n_gran: int, mode: str, *,
                              block: int = DEFAULT_BLOCK) -> float:
    """Ring-model per-device wire of the once-a-step hpZ rebuild (JAX
    :441): the leaves at their stacked dtype ("fp32"), or one blockwise
    payload (1 byte an element after padding to a block) plus its f32
    scales, times (n_gran - 1)."""
    if n_gran <= 1:
        return 0.0
    if mode == "fp32":
        return float(shard_bytes * (n_gran - 1))
    e = shard_elems + (-shard_elems % block)
    return float((e + e // block * 4) * (n_gran - 1))
