# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Paged attention: hand-written CUDA kernels on the card.

Replaces the TPU kernel `tiny_deepspeed_tpu/ops/paged_attn_pallas.py::
paged_attention` (:228, `pallas_call` :311) in all its variants; the
kernels are `csrc/paged_attn.cu` (design and bound in its header):

- decode (`span_kv=None`): one query position per slot attends to pool
  positions <= pos.  Each CTA walks one slot's block-table row itself —
  on the TPU that row arrives through scalar prefetch — and reads each
  (bt, Dh) block of layer `l` straight from the pool with the pool's
  strides, so no (S, KVH, W*bt, Dh) panel is ever gathered into device
  memory;
- span verify (`span_kv=(sk, sv)`): K1 query positions per slot attend
  to pool positions < pos plus the span's own K/V under the windowed
  causal mask — the speculative verify step and the prefix cache's
  suffix prefill;
- int8 / fp8 pool (`view.k_scale` set), either variant: each resting
  element is dequantized in registers against its per-vector f32 scale.

Each variant counts its own launches, so a run can tell them apart:
`paged_attention.launches` decode over a bf16/f16/f32 pool,
`paged_attention_quant.launches` decode over an int8/e4m3 pool and
`paged_attention_span.launches` span verify over any pool.

The plain versions are the JAX package's XLA path: `paged_panel`
(serving/pool.py:130, dequantizing to q's dtype) followed by
`_decode_attention` (models/gpt2.py:392) or `_span_attention`
(models/gpt2.py:671).
"""

from __future__ import annotations

import ctypes
import math
import types

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


_DECODE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                + [ctypes.c_float, ctypes.c_void_p])
_SPAN_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
              + [ctypes.c_float, ctypes.c_void_p])
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
    if not span:
        require(_aligned(view.k, view.v, qc, *scales),
                "paged attention: operands must be 16-byte aligned")
        fn = _build.entry("paged_attn", "paged_decode", _DECODE_ARGS)
        err = fn(qc.data_ptr(), view.k.data_ptr(), view.v.data_ptr(),
                 ks_ptr, vs_ptr, tables.data_ptr(), pos.data_ptr(),
                 o.data_ptr(), s, hq, kvh, dh, bt, nl, int(l), w, qd, kd,
                 1.0 / math.sqrt(dh), _build.stream_ptr(q))
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
             int(l), w, qd, kd, 1.0 / math.sqrt(dh), _build.stream_ptr(q))
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
