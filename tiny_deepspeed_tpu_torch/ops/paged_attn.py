# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Paged decode attention: a hand-written CUDA kernel on the card.

Replaces the TPU kernel `tiny_deepspeed_tpu/ops/paged_attn_pallas.py::
paged_attention` (:228, `pallas_call` :311), decode variant.  The kernel
is `csrc/paged_attn.cu` (design and bound in its header): each CTA walks
one slot's block-table row itself — on the TPU that row arrives through
scalar prefetch — and reads each (bt, Dh) block of layer `l` straight
from the pool with the pool's strides, so no (S, KVH, W*bt, Dh) panel is
ever gathered into device memory.

The plain version is the JAX package's XLA path: `paged_panel`
(serving/pool.py:130) followed by `_decode_attention` (models/gpt2.py:392).
The span-verify and int8/fp8 pool variants of the TPU kernel belong to
the speculative, prefix-cache and quantized-pool slices; they raise
NotImplementedError here.
"""

from __future__ import annotations

import ctypes
import math

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


def _paged_attention_plain(q, view, page, l):
    from ..serving.pool import paged_panel
    ck, cv = paged_panel(view, l, page)
    return decode_attention(q, ck, cv, page.pos)


_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
         + [ctypes.c_float, ctypes.c_void_p])


def _paged_attention_cuda(q, view, page, l: int):
    s, hq, k1, dh = q.shape
    nb, bt, nl, kvh, dk = view.k.shape
    require(k1 == 1, f"paged decode kernel takes one query position per "
            f"slot, got K1={k1}")
    require(dk == dh and view.v.shape == view.k.shape and hq % kvh == 0,
            f"paged decode: q {tuple(q.shape)} vs pool {tuple(view.k.shape)}")
    require(view.k.is_contiguous() and view.v.is_contiguous(),
            "paged decode: the pool must be contiguous")
    require(view.k.dtype == view.v.dtype,
            "paged decode: k/v pool dtypes differ")
    qd = _build.DTYPE_CODES.get(q.dtype)
    kd = _build.DTYPE_CODES.get(view.k.dtype)
    require(qd is not None and kd is not None
            and (qd == kd or q.dtype == torch.float32),
            f"paged decode: q {q.dtype} over a {view.k.dtype} pool is not "
            "instantiated (equal dtypes, or f32 q over a bf16/f16 pool)")
    require(dh in (32, 64, 128), f"paged decode: head dim {dh} not in "
            "(32, 64, 128)")
    require(0 <= int(l) < nl, f"paged decode: layer {l} out of [0, {nl})")
    require(view.k.data_ptr() % 16 == 0 and view.v.data_ptr() % 16 == 0,
            "paged decode: pool storage must be 16-byte aligned")
    tables = page.tables.to(torch.int32).contiguous()
    pos = page.pos.to(torch.int32).contiguous()
    w = tables.shape[1]
    q3 = q.reshape(s, hq, dh).contiguous()
    o = torch.empty_like(q3)
    fn = _build.entry("paged_attn", "paged_decode", _ARGS)
    err = fn(q3.data_ptr(), view.k.data_ptr(), view.v.data_ptr(),
             tables.data_ptr(), pos.data_ptr(), o.data_ptr(),
             s, hq, kvh, dh, bt, nl, int(l), w, qd, kd,
             1.0 / math.sqrt(dh), _build.stream_ptr(q))
    _build.check(err, "paged_decode")
    paged_attention.launches += 1
    return o.reshape(s, hq, 1, dh)


def paged_attention(q, view, page, l, *, span_kv=None):
    """Decode attention over the paged pool: q (S, Hq, 1, Dh); view a
    serving.pool.KVPoolView; page a serving.pool.PageRef; l the layer
    index.  Returns (S, Hq, 1, Dh) in q's dtype.  CUDA tensors launch
    csrc/paged_attn.cu (or raise); CPU tensors take the plain version."""
    if span_kv is not None:
        raise NotImplementedError(
            "the span-verify variant of paged attention belongs to the "
            "speculative-decoding / prefix-cache slice (ROADMAP.md)")
    if view.k_scale is not None:
        raise NotImplementedError(
            "int8/fp8 pool blocks need the quantization kernel slice "
            "(ROADMAP.md)")
    if on_cuda(q, view.k):
        return _paged_attention_cuda(q, view, page, l)
    return _paged_attention_plain(q, view, page, l)


paged_attention.launches = 0  # kernel launches (CUDA path only)
