# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Paged attention: hand-written CUDA kernels on the card.

Replaces the TPU kernel `tiny_deepspeed_tpu/ops/paged_attn_pallas.py::
paged_attention` (:228, `pallas_call` :311) in all its variants; the
kernels are `csrc/paged_attn.cu` (design and bound in its header):

- decode (`span_kv=None`): one query position per slot attends to pool
  positions <= pos;
- span verify (`span_kv=(sk, sv)`): K1 query positions per slot attend
  to pool positions < pos plus the span's own K/V under the windowed
  causal mask — the speculative verify step and the prefix cache's
  suffix prefill;
- int8 / fp8 pool (`view.k_scale` set), either variant: each resting
  element is dequantized against its per-vector f32 scale.

Every kernel reads the block table and the pool itself, with the pool's
strides, so no (S, KVH, W*bt, Dh) panel is gathered into device memory.

The split walk (decode design and span design).  The TPU kernel walks a
slot's table entries on a sequential grid, its softmax statistics carried
in VMEM; Hopper's blocks carry nothing from one to the next.  So the
slot's live keys are cut into tiles and the tiles split, contiguously
and evenly, across the `splits` CTAs of a thread-block cluster; each CTA
reads pos on the device, folds its share into a partial (m, l, acc), and
the cluster merges the partials through distributed shared memory in the
fixed rank order 0..N-1 — one launch, no workspace, no atomics, outputs
bit-identical run to run.  `split_plan` (below) is the host's part:
splits from W and bt (each split keeps at least two tiles on average)
and from the CTA count (the grid within the kernel's CTAs an SM over the
card), and the few-rows / many-rows switch.  Every kernel streams its
tiles through a two-stage `cp.async` ring in the pool's resting dtype
(decode: each warp its own slice of a tile).  A span of more than 16 rows
(G*K1, the suffix prefill) with bf16/f16 q and Dh 32 or 64 runs on the
tensor cores (`wgmma`, FA2's forward over a paged source; an int8 / e4m3
tile is dequantized to bf16 before its product, as `paged_panel` does);
few rows (the speculative verify step), f32 and Dh = 128 stay on FP32
FMAs.  `split_range` is the device's split arithmetic and
`merge_partials` a plain reference of its merge (tests only).

Each variant counts its own launches, one per call, so a run can tell
them apart: `paged_attention.launches` decode over a bf16/f16/f32 pool,
`paged_attention_quant.launches` decode over an int8/e4m3 pool and
`paged_attention_span.launches` span verify over any pool.

The plain versions are the JAX package's XLA path: `paged_panel`
(serving/pool.py:130, dequantizing to q's dtype) followed by
`_decode_attention` (models/gpt2.py:392) or `_span_attention`
(models/gpt2.py:671).
"""

from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import NamedTuple

import torch

from . import _build
from .dispatch import on_cuda, require


def decode_attention(q, ck, cv, pos):
    """q (B, Hq, 1, Dh); ck/cv (B, Hkv, T, Dh) panels; pos (B,) — row b
    attends to cache positions <= pos[b].  Mirrors the JAX
    `_decode_attention`: q cast to the cache's resting dtype, f32 scores,
    -inf mask, softmax in f32, probabilities cast to the cache dtype
    before PV with f32 accumulation, output in q's dtype.  GQA groups
    query heads per KV head."""
    b, hq, _, dh = q.shape
    hkv, t = ck.shape[1], ck.shape[2]
    out_dtype = q.dtype
    qf = q.to(ck.dtype).float().reshape(b, hkv, hq // hkv, dh)
    kf = ck.float()
    att = torch.einsum("bkgd,bktd->bkgt", qf, kf) * (1.0 / math.sqrt(dh))
    mask = torch.arange(t, device=q.device)[None, :] <= pos[:, None]
    att = att.masked_fill(~mask[:, None, None, :], float("-inf"))
    att = torch.softmax(att, dim=-1)
    y = torch.einsum("bkgt,bktd->bkgd", att.to(cv.dtype).float(), cv.float())
    return y.reshape(b, hq, 1, dh).to(out_dtype)


def span_attention(q, ck, cv, sk, sv, pos0):
    """Windowed-causal attention over committed cache + span (JAX
    `_span_attention`, models/gpt2.py:671).  q (S, Hq, K1, Dh); ck/cv
    (S, KVH, T, Dh) pool panels (positions < pos0 valid); sk/sv (S, KVH,
    K1, Dh) the span's own K/V.  Query j sees pool positions < pos0[s]
    plus span offsets <= j.  q and the span K/V are cast to the panel's
    dtype; scores and softmax in f32, probabilities cast back to it
    before PV with f32 accumulation; output in q's dtype."""
    s, hq, k1, dh = q.shape
    hkv, t = ck.shape[1], ck.shape[2]
    out_dtype = q.dtype
    kf = torch.cat([ck, sk.to(ck.dtype)], dim=2).float()
    vf = torch.cat([cv, sv.to(cv.dtype)], dim=2)
    qf = q.to(ck.dtype).float().reshape(s, hkv, hq // hkv, k1, dh)
    pool_mask = (torch.arange(t, device=q.device)[None, None, :]
                 < pos0.long()[:, None, None]).expand(s, k1, t)
    span_mask = torch.ones(k1, k1, dtype=torch.bool,
                           device=q.device).tril()[None].expand(s, k1, k1)
    mask = torch.cat([pool_mask, span_mask], dim=-1)  # (S, K1, T + K1)
    att = torch.einsum("skgqd,sktd->skgqt", qf, kf) * (1.0 / math.sqrt(dh))
    att = att.masked_fill(~mask[:, None, None], float("-inf"))
    att = torch.softmax(att, dim=-1)
    y = torch.einsum("skgqt,sktd->skgqd", att.to(vf.dtype).float(),
                     vf.float())
    return y.reshape(s, hq, k1, dh).to(out_dtype)


def _paged_attention_plain(q, view, page, l, span_kv=None):
    from ..serving.pool import paged_panel
    ck, cv = paged_panel(view, l, page, q.dtype)
    if span_kv is None:
        return decode_attention(q, ck, cv, page.pos)
    return span_attention(q, ck, cv, *span_kv, page.pos)


SMS = 132          # the H100 SXM's streaming multiprocessors
MAX_SPLITS = 8     # the portable cluster size (csrc MAX_SPLITS)
FEW_ROWS = 16      # span rows G*K1 at or below this stay on FMA
# (keys a tile, query rows a CTA, CTAs an SM the plan aims at) per
# kernel: csrc decode::TK; sfma::TK, ::ROWS; tc::BK, ::BQ
_GEOMETRY = {"decode": (64, None, 6), "span_fma": (32, 16, 6),
             "span_wgmma": (64, 64, 3)}


class SplitPlan(NamedTuple):
    """How one paged-attention call is cut: `kernel` ("decode",
    "span_fma" or "span_wgmma"), `splits` CTAs of a cluster sharing each
    walk, `tile` keys a tile, `rows` query rows a CTA holds (the G group
    heads at decode), `row_tiles` CTAs' worth of rows per (slot, kv
    head), `grid` (row_tiles * splits, KVH, S), and `k1` the span."""

    kernel: str
    splits: int
    tile: int
    rows: int
    row_tiles: int
    grid: tuple
    k1: int


@functools.lru_cache(maxsize=256)  # once per shape: serving is host-bound
def split_plan(*, s: int, hq: int, kvh: int, k1: int, dh: int, w: int,
               bt: int, q_dtype, span: bool) -> SplitPlan:
    """The host's part of the split walk, from shapes alone (no device
    value is read).  A span of more than FEW_ROWS rows G*K1 with bf16/f16
    q and Dh 32 or 64 takes the tensor cores; other spans the FMA kernel.
    Splits double, up to MAX_SPLITS, while each split keeps at least two
    tiles of the longest walk (W*bt pool keys, plus the span's) and the
    grid stays within the kernel's CTAs per SM over the card."""
    g = hq // kvh
    if not span:
        kernel = "decode"
    elif (g * k1 > FEW_ROWS and dh in (32, 64)
          and q_dtype in (torch.bfloat16, torch.float16)):
        kernel = "span_wgmma"
    else:
        kernel = "span_fma"
    tile, rows, per_sm = _GEOMETRY[kernel]
    rows = rows or g
    row_tiles = -(-g * k1 // rows) if span else 1
    ntiles = -(-w * bt // tile) + (-(-k1 // tile) if span else 0)
    base = s * kvh * row_tiles
    splits = 1
    while (splits < MAX_SPLITS and 4 * splits <= ntiles
           and 2 * splits * base <= per_sm * SMS):
        splits *= 2
    return SplitPlan(kernel, splits, tile, rows, row_tiles,
                     (row_tiles * splits, kvh, s), k1)


def split_range(n: int, splits: int, rank: int):
    """Tiles [lo, hi) of `n` that split `rank` walks: contiguous,
    ceil(n / splits) each, the last ones short or empty — the kernels'
    `split_range`, which each CTA evaluates on the device with n from
    pos."""
    per = -(-n // splits)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def split_keys(plan: SplitPlan, rank: int, n: int, row_tile: int = 0,
               r_total: int = 1):
    """The keys split `rank` of `plan` folds for one (slot, kv head, row
    tile), as the kernels compute them: decode, live positions [lo, hi)
    of n = min(pos + 1, W*bt); span (n = min(pos0, W*bt) pool positions,
    r_total = G*K1 rows), pool positions [lo, hi) and span offsets
    [jlo, jhi) — the span's tiles follow the pool's in the split."""
    t = plan.tile
    if plan.kernel == "decode":
        lo, hi = split_range(-(-n // t), plan.splits, rank)
        return min(lo * t, n), min(hi * t, n)
    r0 = row_tile * plan.rows
    rend = min(r0 + plan.rows, r_total)
    k1 = plan.k1
    jmax = (k1 - 1 if rend - r0 >= k1 or r0 // k1 != (rend - 1) // k1
            else (rend - 1) % k1)
    npt = -(-n // t)
    lo, hi = split_range(npt + jmax // t + 1, plan.splits, rank)
    pool = (min(lo * t, n), min(min(hi, npt) * t, n))
    span = (min(max(lo - npt, 0) * t, k1), min(max(hi - npt, 0) * t, k1))
    return pool, span


def merge_partials(parts):
    """Plain reference of the kernels' cluster merge: `parts` the splits'
    partial states in rank order, each (m (R,), l (R,), acc (R, D)) — m
    the running max of scores in log2 units, l the sum of exp2(score -
    m), acc the unnormalised output; an empty split is (-1e30, 0, 0).
    Returns the merged output (R, D) in f32, sum_k acc_k exp2(m_k - M)
    / L with M = max_k m_k and L = sum_k l_k exp2(m_k - M), folded in rank
    order as the kernels fold it.  Used by tests only."""
    m = torch.stack([p[0] for p in parts]).float()
    big = m.max(dim=0).values
    c = torch.exp2(m - big)
    el = sum(p[1].float() * c[k] for k, p in enumerate(parts))
    out = torch.zeros_like(parts[0][2], dtype=torch.float32)
    for k, p in enumerate(parts):
        out = out + p[2].float() * (c[k] / el)[:, None]
    return out


_DECODE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_SPAN_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
              + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p])
_QUANT_Q = (torch.float32, torch.bfloat16)  # q types over int8 / e4m3


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _paged_attention_cuda(q, view, page, l: int, span_kv=None):
    s, hq, k1, dh = q.shape
    nb, bt, nl, kvh, dk = view.k.shape
    span = span_kv is not None
    quant = view.k_scale is not None
    require(span or k1 == 1, f"paged decode kernel takes one query "
            f"position per slot, got K1={k1}")
    require(dk == dh and view.v.shape == view.k.shape and hq % kvh == 0,
            f"paged attention: q {tuple(q.shape)} vs pool "
            f"{tuple(view.k.shape)}")
    require(view.k.is_contiguous() and view.v.is_contiguous(),
            "paged attention: the pool must be contiguous")
    require(view.k.dtype == view.v.dtype,
            "paged attention: k/v pool dtypes differ")
    qd = _build.DTYPE_CODES.get(q.dtype)
    kd = _build.POOL_CODES.get(view.k.dtype)
    is_q8 = view.k.dtype in (torch.int8, torch.float8_e4m3fn)
    require(qd is not None and kd is not None
            and ((is_q8 and q.dtype in _QUANT_Q) or qd == kd
                 or (q.dtype == torch.float32 and not is_q8)),
            f"paged attention: q {q.dtype} over a {view.k.dtype} pool is "
            "not instantiated (equal dtypes, f32 q over a bf16/f16 pool, "
            "or f32/bf16 q over an int8/e4m3 pool)")
    require(quant == is_q8 and (view.v_scale is not None) == quant,
            f"paged attention: a {view.k.dtype} pool needs scales iff it "
            "is int8/e4m3")
    scales = []
    if quant:
        require(view.k_scale.shape == view.k.shape[:-1]
                and view.v_scale.shape == view.k.shape[:-1]
                and view.k_scale.dtype == view.v_scale.dtype == torch.float32
                and view.k_scale.is_contiguous()
                and view.v_scale.is_contiguous(),
                "paged attention: scales must be contiguous f32 "
                "(NB, bt, L, KVH)")
        scales = [view.k_scale, view.v_scale]
    require(dh in (32, 64, 128), f"paged attention: head dim {dh} not in "
            "(32, 64, 128)")
    require(0 <= int(l) < nl, f"paged attention: layer {l} out of [0, {nl})")
    tables = page.tables.to(torch.int32).contiguous()
    pos = page.pos.to(torch.int32).contiguous()
    w = tables.shape[1]
    qc = q.contiguous()
    o = torch.empty_like(qc)
    ks_ptr = view.k_scale.data_ptr() if quant else None
    vs_ptr = view.v_scale.data_ptr() if quant else None
    plan = split_plan(s=s, hq=hq, kvh=kvh, k1=k1, dh=dh, w=w, bt=bt,
                      q_dtype=q.dtype, span=span)
    if not span:
        require(_aligned(view.k, view.v, qc, *scales),
                "paged attention: operands must be 16-byte aligned")
        fn = _build.entry("paged_attn", "paged_decode", _DECODE_ARGS)
        err = fn(qc.data_ptr(), view.k.data_ptr(), view.v.data_ptr(),
                 ks_ptr, vs_ptr, tables.data_ptr(), pos.data_ptr(),
                 o.data_ptr(), s, hq, kvh, dh, bt, nl, int(l), w, qd, kd,
                 1.0 / math.sqrt(dh), plan.splits, _build.stream_ptr(q))
        _build.check(err, "paged_decode")
        if quant:
            paged_attention_quant.launches += 1
        else:
            paged_attention.launches += 1
        return o
    sk, sv = span_kv  # shapes checked by `paged_attention`
    require(sk.dtype == sv.dtype == q.dtype,
            f"paged attention span: sk/sv {sk.dtype}/{sv.dtype} must be "
            f"q's dtype {q.dtype}")
    skc, svc = sk.contiguous(), sv.contiguous()
    require(_aligned(view.k, view.v, qc, skc, svc, *scales),
            "paged attention: operands must be 16-byte aligned")
    fn = _build.entry("paged_attn", "paged_span", _SPAN_ARGS)
    err = fn(qc.data_ptr(), view.k.data_ptr(), view.v.data_ptr(), ks_ptr,
             vs_ptr, skc.data_ptr(), svc.data_ptr(), tables.data_ptr(),
             pos.data_ptr(), o.data_ptr(), s, hq, kvh, k1, dh, bt, nl,
             int(l), w, qd, kd, 1.0 / math.sqrt(dh), plan.splits,
             int(plan.kernel == "span_wgmma"), _build.stream_ptr(q))
    _build.check(err, "paged_span")
    paged_attention_span.launches += 1
    return o


def paged_attention(q, view, page, l, *, span_kv=None):
    """Attention over the paged pool: q (S, Hq, K1, Dh); view a
    serving.pool.KVPoolView (int8/fp8 pools carry scales); page a
    serving.pool.PageRef; l the layer index.  span_kv=None is the decode
    variant (K1 = 1, positions <= page.pos); span_kv=(sk, sv), each
    (S, KVH, K1, Dh), the span-verify variant (positions < page.pos plus
    span offsets <= j).  Returns (S, Hq, K1, Dh) in q's dtype.  CUDA
    tensors launch csrc/paged_attn.cu (or raise); CPU tensors take the
    plain version."""
    if span_kv is not None:
        s, hq, k1, dh = q.shape
        kvh = view.k.shape[3]
        for t in span_kv:
            if tuple(t.shape) != (s, kvh, k1, dh):
                raise ValueError(
                    f"paged attention span: span K/V {tuple(t.shape)}, "
                    f"expected {(s, kvh, k1, dh)} for q {tuple(q.shape)}")
    if on_cuda(q, view.k):
        return _paged_attention_cuda(q, view, page, l, span_kv)
    return _paged_attention_plain(q, view, page, l, span_kv)


# kernel launches (CUDA path only), one count per variant
paged_attention.launches = 0  # decode over a bf16/f16/f32 pool
paged_attention_quant = types.SimpleNamespace(launches=0)  # int8/e4m3 pool
paged_attention_span = types.SimpleNamespace(launches=0)  # span, any pool
