# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The split walk of the paged-attention kernels, on the CPU.

The kernels (csrc/paged_attn.cu) cut each slot's keys into tiles, split
the tiles across the CTAs of a cluster and merge the CTAs' partial
softmax states (m, l, acc) in a fixed rank order.  Here the host's plan
(`split_plan`), the device's split arithmetic (`split_range`,
`split_keys`) and a plain reference of the merge (`merge_partials`) are
held, over the plan's ranges, against the plain `decode_attention` /
`span_attention` and against the JAX package's `paged_attention` run as
its own tests run it on the CPU (Pallas interpret mode): f32, numpy-seeded
inputs, atol = rtol = 1e-5 (the sides differ only in summation order).
Covered: empty splits, pos 0, a live range ending on a split boundary, a
span with an empty pool part, grouped heads, and both span kernels'
geometries (16-row FMA tiles of 32 keys, 64-row tensor-core tiles of 64).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.paged_attn_pallas as JPA
from tiny_deepspeed_tpu.serving import pool as jpool
from tiny_deepspeed_tpu_torch.ops import paged_attn as pa
from tiny_deepspeed_tpu_torch.serving import pool as tpool

TOL = dict(atol=1e-5, rtol=1e-5)
LOG2E = 1.4426950408889634
MASKED = -1e30  # csrc/common.cuh kMasked


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JPA, "INTERPRET", True)


def _partial(q, k, v, mask):
    """One split's partial state: q (R, D), k/v (T, D), mask (R, T) ->
    (m, l, acc) with scores in log2 units, as the kernels keep them;
    (MASKED, 0, 0) for a row that sees no key."""
    r, d = q.shape
    if k.shape[0] == 0:
        return (torch.full((r,), MASKED), torch.zeros(r),
                torch.zeros(r, d))
    s = (q @ k.T) * (LOG2E / math.sqrt(d))
    s = s.masked_fill(~mask, MASKED)
    m = s.max(dim=-1).values
    p = torch.where(mask, torch.exp2(s - m[:, None]), torch.zeros(()))
    return m, p.sum(dim=-1), p @ v


def _inputs(seed, s, hq, kvh, d, bt, w, nl=2, k1=None):
    rng = np.random.default_rng(seed)
    shape = (s * w + 1, bt, nl, kvh, d)
    kp, vp = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    tables = (rng.permutation(s * w) + 1).reshape(s, w).astype(np.int32)
    q = rng.standard_normal((s, hq, k1 or 1, d)).astype(np.float32)
    span = None
    if k1 is not None:
        span = tuple(rng.standard_normal((s, kvh, k1, d)).astype(np.float32)
                     for _ in range(2))
    return kp, vp, tables, q, span


def _split_decode(q, ck, cv, pos, plan):
    """Decode through the plan: every (slot, kv head) walks its live
    keys split by split, then the merge."""
    s, hq, _, d = q.shape
    kvh = ck.shape[1]
    g = hq // kvh
    out = torch.zeros(s, hq, 1, d)
    for si in range(s):
        n = min(int(pos[si]) + 1, ck.shape[2])
        for h in range(kvh):
            qs = q[si, h * g:(h + 1) * g, 0]
            parts = []
            for rank in range(plan.splits):
                lo, hi = pa.split_keys(plan, rank, n)
                parts.append(_partial(qs, ck[si, h, lo:hi], cv[si, h, lo:hi],
                                      torch.ones(g, hi - lo, dtype=bool)))
            out[si, h * g:(h + 1) * g, 0] = pa.merge_partials(parts)
    return out


def _split_span(q, ck, cv, sk, sv, pos0, plan):
    """Span verify through the plan: each (slot, kv head, row tile)
    walks its pool keys and then its span offsets, split by split."""
    s, hq, k1, d = q.shape
    kvh = ck.shape[1]
    r_total = (hq // kvh) * k1
    out = torch.zeros(s, hq, k1, d)
    for si in range(s):
        n = min(int(pos0[si]), ck.shape[2])
        for h in range(kvh):
            rows = q[si, h * (hq // kvh):(h + 1) * (hq // kvh)].reshape(
                r_total, d)
            merged = torch.zeros(r_total, d)
            for rt in range(plan.row_tiles):
                r0 = rt * plan.rows
                rend = min(r0 + plan.rows, r_total)
                jq = torch.arange(r0, rend) % k1
                parts = []
                for rank in range(plan.splits):
                    (plo, phi), (jlo, jhi) = pa.split_keys(
                        plan, rank, n, rt, r_total)
                    k = torch.cat([ck[si, h, plo:phi], sk[si, h, jlo:jhi]])
                    v = torch.cat([cv[si, h, plo:phi], sv[si, h, jlo:jhi]])
                    mask = torch.cat([
                        torch.ones(rend - r0, phi - plo, dtype=bool),
                        torch.arange(jlo, jhi)[None, :] <= jq[:, None]], 1)
                    parts.append(_partial(rows[r0:rend], k, v, mask))
                merged[r0:rend] = pa.merge_partials(parts)
            out[si, h * (hq // kvh):(h + 1) * (hq // kvh)] = merged.reshape(
                hq // kvh, k1, d)
    return out


def _jax_paged(kp, vp, tables, q, pos, bt, layer, span=None):
    view = jpool.KVPoolView(jnp.asarray(kp), jnp.asarray(vp), None, None)
    page = jpool.page_ref(jnp.asarray(tables), jnp.asarray(pos), bt)
    kw = {} if span is None else dict(
        span_kv=tuple(jnp.asarray(a) for a in span))
    return np.asarray(JPA.paged_attention(jnp.asarray(q), view, page, layer,
                                          **kw))


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("kw,want", [
    # chip_smoke's shapes: decode, its long context, spec verify, suffix
    (dict(s=8, k1=1, w=64, span=False), ("decode", 8, 1, (8, 12, 8))),
    (dict(s=8, k1=1, w=256, span=False), ("decode", 8, 1, (8, 12, 8))),
    (dict(s=8, k1=5, w=64, span=True), ("span_fma", 8, 1, (8, 12, 8))),
    (dict(s=2, k1=256, w=64, span=True), ("span_wgmma", 4, 4, (16, 12, 2))),
    # f32 and Dh = 128 keep FMA; 16 rows FMA, 17 the tensor cores
    (dict(s=2, k1=256, w=64, span=True, q_dtype=torch.float32),
     ("span_fma", 2, 16, (32, 12, 2))),
    (dict(s=2, k1=256, w=64, span=True, dh=128),
     ("span_fma", 2, 16, (32, 12, 2))),
    (dict(s=2, k1=16, w=64, span=True), ("span_fma", 8, 1, (8, 12, 2))),
    (dict(s=2, k1=17, w=64, span=True), ("span_wgmma", 8, 1, (8, 12, 2))),
    # a short table keeps one split; a full card keeps one too
    (dict(s=5, k1=1, w=6, span=False), ("decode", 1, 1, (1, 12, 5))),
    (dict(s=64, k1=1, w=64, span=False), ("decode", 1, 1, (1, 12, 64))),
    (dict(s=16, k1=1, w=64, span=False), ("decode", 4, 1, (4, 12, 16))),
])
def test_split_plan(kw, want):
    args = dict(hq=12, kvh=12, dh=64, bt=16, q_dtype=torch.bfloat16)
    args.update(kw)
    plan = pa.split_plan(**args)
    assert (plan.kernel, plan.splits, plan.row_tiles, plan.grid) == want
    assert 1 <= plan.splits <= pa.MAX_SPLITS
    assert plan.splits & (plan.splits - 1) == 0


def test_split_plan_grouped_rows():
    """Rows are G*K1 per (slot, kv head): GQA 4/2 at K1 = 8 is 16 rows
    (FMA), at K1 = 9 18 rows (the tensor cores, one 64-row tile)."""
    kw = dict(s=2, hq=4, kvh=2, dh=64, w=64, bt=16, q_dtype=torch.bfloat16,
              span=True)
    assert pa.split_plan(k1=8, **kw).kernel == "span_fma"
    plan = pa.split_plan(k1=9, **kw)
    assert plan.kernel == "span_wgmma" and plan.row_tiles == 1
    assert pa.split_plan(s=2, hq=4, kvh=2, k1=1, dh=64, w=64, bt=16,
                         q_dtype=torch.bfloat16, span=False).rows == 2


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
def test_split_range_covers_once(splits):
    """Ranges are contiguous and disjoint, cover [0, n) in rank order,
    hold at most ceil(n / splits) each, and trailing ones may be empty."""
    for n in range(0, 70):
        got = [pa.split_range(n, splits, r) for r in range(splits)]
        assert got[0][0] == 0 and got[-1][1] == n
        for (lo, hi), (lo2, _) in zip(got, got[1:]):
            assert lo <= hi == lo2
        assert all(hi - lo <= -(-n // splits) for lo, hi in got)


def test_merge_with_empty_splits_is_the_partial():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((3, 16), (10, 16), (10, 16)))
    part = _partial(q, k, v, torch.ones(3, 10, dtype=bool))
    empty = _partial(q, k[:0], v[:0], torch.ones(3, 0, dtype=bool))
    want = part[2] / part[1][:, None]
    for parts in ([part], [empty, part, empty], [part, empty, empty]):
        torch.testing.assert_close(pa.merge_partials(parts), want, **TOL)


# -- the split walk against the plain path and JAX ------------------------------

@pytest.mark.parametrize("hq,kvh", [(4, 4), (4, 2), (2, 1)])
@pytest.mark.parametrize("splits,tile", [(None, None), (1, 64), (2, 8),
                                         (3, 8), (8, 8), (8, 64)])
def test_decode_split_matches_plain_and_pallas(hq, kvh, splits, tile):
    """pos 0; a live range of 48 keys, which ends a split exactly at
    tile 8 (6 tiles, 2 or 3 splits); the table's last position; and one
    within the first tile."""
    s, d, bt, w = 4, 16, 8, 12
    kp, vp, tables, q, _ = _inputs(hq + kvh, s, hq, kvh, d, bt, w)
    pos = np.asarray([0, 47, w * bt - 1, 5], np.int32)
    view = tpool.KVPoolView(torch.from_numpy(kp), torch.from_numpy(vp))
    page = tpool.page_ref(torch.from_numpy(tables), torch.from_numpy(pos),
                          bt)
    plan = pa.split_plan(s=s, hq=hq, kvh=kvh, k1=1, dh=d, w=w, bt=bt,
                         q_dtype=torch.float32, span=False)
    if splits is not None:
        plan = plan._replace(splits=splits, tile=tile)
    tq = torch.from_numpy(q)
    for layer in range(2):
        ck, cv = tpool.paged_panel(view, layer, page)
        got = _split_decode(tq, ck, cv, pos, plan)
        plain = pa.decode_attention(tq, ck, cv, page.pos)
        torch.testing.assert_close(got, plain, **TOL)
        np.testing.assert_allclose(
            got.numpy(), _jax_paged(kp, vp, tables, q, pos, bt, layer),
            **TOL)


@pytest.mark.parametrize("k1,hq,kvh", [(5, 4, 4), (3, 4, 2), (17, 2, 1),
                                       (40, 2, 2)])
@pytest.mark.parametrize("geometry", ["plan", "fma", "wgmma"])
@pytest.mark.parametrize("splits", [None, 2, 8])
def test_span_split_matches_plain_and_pallas(k1, hq, kvh, geometry, splits):
    """Both span kernels' tiles and rows (the FMA kernel's 32 keys x 16
    rows, the tensor cores' 64 x 64; 8-key tiles give many splits a
    short table), pos0 = 0 (an empty pool part: only the span's keys),
    a pool part ending on a tile boundary, and up to the table's end."""
    s, d, bt, w = 4, 16, 8, 10
    kp, vp, tables, q, span = _inputs(k1 + hq, s, hq, kvh, d, bt, w, k1=k1)
    pos0 = np.asarray([0, 32, 13, w * bt - k1], np.int32)
    view = tpool.KVPoolView(torch.from_numpy(kp), torch.from_numpy(vp))
    page = tpool.page_ref(torch.from_numpy(tables), torch.from_numpy(pos0),
                          bt)
    plan = pa.split_plan(s=s, hq=hq, kvh=kvh, k1=k1, dh=d, w=w, bt=bt,
                         q_dtype=torch.float32, span=True)
    if geometry != "plan":
        tile, rows = (32, 16) if geometry == "fma" else (64, 64)
        if splits is not None:
            tile = 8
        plan = plan._replace(
            kernel="span_" + geometry, tile=tile, rows=rows,
            row_tiles=-(-(hq // kvh) * k1 // rows))
    if splits is not None:
        plan = plan._replace(splits=splits)
    tq, sk, sv = (torch.from_numpy(a) for a in (q, *span))
    for layer in range(2):
        ck, cv = tpool.paged_panel(view, layer, page)
        got = _split_span(tq, ck, cv, sk, sv, pos0, plan)
        plain = pa.span_attention(tq, ck, cv, sk, sv, page.pos)
        torch.testing.assert_close(got, plain, **TOL)
        np.testing.assert_allclose(
            got.numpy(),
            _jax_paged(kp, vp, tables, q, pos0, bt, layer, span), **TOL)
