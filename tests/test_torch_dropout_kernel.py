# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""csrc/dropout.cu's arithmetic on the CPU: a numpy model of the kernel,
step by step as it runs — a warp per (row, column chunk), each lane's
first state one 64-bit product, GOLDEN added an element and 32 vectors'
worth a vector, the hash on 32-bit halves (the first product as a wide
multiply and two cross multiply-adds, only the high word of the second),
the integer compare against `keep_threshold` — held bit for bit to
`dropout_keep`, the plain version the card check holds the kernel to.
Also `keep_threshold` against the f32 compare it replaces, and the
wrapper's choice of access width."""

import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu_torch.ops import dropout as D

M32 = np.uint64(0xFFFFFFFF)
GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MIX1_LO, MIX1_HI = np.uint32(0x1CE4E5B9), np.uint32(0xBF58476D)
MIX2_LO, MIX2_HI = np.uint32(0x133111EB), np.uint32(0x94D049BB)
UNROLL = 4  # kUnroll: vectors a lane keeps in flight


def _funnel_r(lo, hi, s):
    """__funnelshift_r(lo, hi, s): the low word of (hi:lo) >> s."""
    return (lo >> np.uint32(s)) | (hi << np.uint32(32 - s))


def _umulhi(a, b):
    return ((a.astype(np.uint64) * np.uint64(b)) >> np.uint64(32)).astype(
        np.uint32)


def kept(z, thr):
    """The kernel's `kept`: z (uint64) -> the keep bits, on 32-bit halves."""
    lo = (z & M32).astype(np.uint32)
    hi = (z >> np.uint64(32)).astype(np.uint32)
    vl = lo ^ _funnel_r(lo, hi, 30)
    vh = hi ^ (hi >> np.uint32(30))
    p = vl.astype(np.uint64) * np.uint64(MIX1_LO)
    zl = (p & M32).astype(np.uint32)
    zh = (p >> np.uint64(32)).astype(np.uint32) + vl * MIX1_HI + vh * MIX1_LO
    wl = zl ^ _funnel_r(zl, zh, 27)
    wh = zh ^ (zh >> np.uint32(27))
    top = _umulhi(wl, MIX2_LO) + wl * MIX2_HI + wh * MIX2_LO
    return (top >> np.uint32(8)) < np.uint32(thr)


def kernel_model(key, shape, keep, frame=None, vec=8):
    """The keep mask as the kernel's lanes draw it (numpy, uint64 and
    uint32 arithmetic wrapping as the card's does)."""
    a, t, c, gt, gc, oa, ot, oc = D._geometry(torch.empty(shape), frame)
    rows, nv = a * t, c // vec
    assert c % vec == 0
    chunks = -(-nv // (32 * UNROLL))
    thr = D.keep_threshold(keep)
    out = np.zeros((rows, c), bool)
    # every (row, chunk, lane) of the launch
    r, chunk, lane = (x.ravel() for x in np.meshgrid(
        np.arange(rows, dtype=np.int64), np.arange(chunks, dtype=np.int64),
        np.arange(32, dtype=np.int64), indexing="ij"))
    ai = r // t
    grow = (ai + oa) * gt + (r - ai * t) + ot
    v0 = chunk * (32 * UNROLL) + lane
    with np.errstate(over="ignore"):
        g1 = (grow * gc + oc + v0 * vec + 1).astype(np.uint64)
        z = g1 * GOLDEN + np.uint64(key)
        step = GOLDEN * np.uint64(32 * vec)
        for u in range(UNROLL):
            v = v0 + u * 32
            live = v < nv
            zi = z.copy()
            for j in range(vec):
                out[r[live], v[live] * vec + j] = kept(zi[live], thr)
                zi += GOLDEN
            z += step
    return torch.from_numpy(out.reshape(shape))


KEYS = [0, 1, 0xD0D0, 2 ** 63 + 12345, 2 ** 64 - 1,
        *np.random.default_rng(22).integers(0, 2 ** 63, 3).tolist()]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape,vec", [((2, 5, 256), 8), ((3, 7, 96), 4),
                                       ((1, 2, 1040), 8), ((6, 64), 8),
                                       ((4096,), 8), ((13, 3), 1),
                                       ((2, 3, 771), 1)])
def test_model_matches_plain_mask(key, shape, vec):
    """Vector widths 8 / 4 / 1, rows of 1 to 9 chunks, 1- to 3-D."""
    for keep in (0.9, 0.5, 0.123):
        want = D.dropout_keep(key, shape, keep, "cpu")
        assert torch.equal(kernel_model(key, shape, keep, None, vec), want)


@pytest.mark.parametrize("shape,frame", [
    ((2, 3, 16), ((8, 12, 32), (2, 6, 16))),        # a data x seq block
    ((1, 4, 40), ((3, 5, 48), (2, 1, 8))),          # every offset
    ((1, 5, 96), ((4, 2 ** 20, 4097), (3, 2 ** 20 - 5, 4000))),
    ((2, 2, 64), ((5, 3 ** 13, 3 ** 9), (3, 3 ** 13 - 2, 17))),
    ((7, 32), ((2 ** 22, 2 ** 12), (2 ** 22 - 7, 4000))),
    ((48,), ((2 ** 40,), (2 ** 40 - 48,))),
])
@pytest.mark.parametrize("key", KEYS[:4])
def test_model_matches_plain_mask_in_frames(shape, frame, key):
    """Blocks at offsets, global indices up to 2**40 (past 2**32, where
    the first state's product and the row's index need all 64 bits)."""
    vec = 8 if shape[-1] % 8 == 0 else 1
    want = D.dropout_keep(key, shape, 0.9, "cpu", frame)
    assert torch.equal(kernel_model(key, shape, 0.9, frame, vec), want)


def test_frames_reach_past_2_32():
    """The frames above do hold indices past 2**32."""
    g = D.global_index((1, 5, 96), ((4, 2 ** 20, 4097),
                                    (3, 2 ** 20 - 5, 4000)), "cpu")
    assert int(g.min()) > 2 ** 32 and int(g.max()) < 2 ** 63


RATES = [0.0, 0.01, 0.1, 0.123456, 1 / 3, 0.5, 0.7, 0.9, 0.95, 0.99]


@pytest.mark.parametrize("rate", RATES)
def test_keep_threshold_is_the_f32_compare(rate):
    """k < keep_threshold(keep) exactly when k * 2**-24 < keep in f32,
    for every k within 8 of the threshold (and the ends)."""
    keep = 1.0 - rate
    thr = D.keep_threshold(keep)
    ks = torch.arange(max(thr - 8, 0), min(thr + 9, 1 << 24))
    ks = torch.cat([ks, torch.tensor([0, (1 << 24) - 1])])
    u = ks.to(torch.float32) * (1.0 / (1 << 24))
    want = u < torch.tensor(keep, dtype=torch.float32)
    assert torch.equal(ks < thr, want)
    assert 0 <= thr <= 1 << 24


def test_keep_threshold_ends():
    assert D.keep_threshold(1.0) == 1 << 24
    assert D.keep_threshold(0.0) == 0
    assert D.keep_threshold(0.5) == 1 << 23
    # f32(0.9) is 0.89999997615814208984375 = 15099494 * 2**-24 exactly
    assert D.keep_threshold(0.9) == 15099494


def test_vector_width():
    """16 bytes' worth when the row length tiles and both operands are
    16-byte aligned, else element accesses."""
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    x, y = buf[:2048].view(8, 256), torch.zeros(8, 256, dtype=torch.bfloat16)
    assert D.vector_width(x, y, 256) == 8
    assert D.vector_width(x.float(), y.float(), 256) == 4
    assert D.vector_width(x, y, 252) == 1
    assert D.vector_width(buf[1:2049].view(8, 256), y, 256) == 1
    assert D.vector_width(x, buf[1:2049].view(8, 256), 256) == 1
