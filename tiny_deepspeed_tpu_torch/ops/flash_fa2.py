# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Causal FlashAttention-2 forward: a hand-written CUDA kernel on the card.

Replaces the TPU kernel `tiny_deepspeed_tpu/ops/flash_fa2.py::
fa2_flash_attention` (:381) -> `_fwd` (:125, `pallas_call` :129).  The
kernel is `csrc/flash_fwd.cu` (design and bound in its header): K/V
stream through shared memory in tiles, so any T works and the TPU
package's `FA2_MAX_T` VMEM bound has no counterpart.  Grouped K/V
(KVH | H, query head h reads kv head h // group) run natively, as in the
JAX kernel.

`fa2_flash_attention_fwd` returns (o, lse): lse = m + log(l) in f32, the
one fused statistic the training slice's backward will consume.  The
dq/dkv backward kernels wait for that slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .dispatch import on_cuda, require


def _fa2_fwd_plain(q, k, v):
    """The plain PyTorch version: `standard_attention` (JAX
    ops/attention.py:35 — f32 logits, finfo.min causal mask, probs cast to
    the input dtype before PV) plus its row logsumexp.  q (B, H, T, Dh);
    k/v (B, KVH, T, Dh).  Returns (o like q, lse (B, H, T) f32)."""
    group = q.shape[1] // k.shape[1]
    if group > 1:  # query heads of one group are adjacent
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    t, dh = q.shape[-2], q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * (1.0 / math.sqrt(dh))
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), lse


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                      ctypes.c_void_p]


def _fa2_fwd_cuda(q, k, v):
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            f"flash_fwd: q (B,H,T,Dh), k/v (B,KVH,T,Dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, dh = q.shape
    kvh = k.shape[1]
    require(k.shape[0] == b and k.shape[2] == t and k.shape[3] == dh
            and kvh >= 1 and h % kvh == 0,
            f"flash_fwd: k/v {tuple(k.shape)} do not group q {tuple(q.shape)}")
    require(q.dtype == k.dtype == v.dtype
            and q.dtype in _build.DTYPE_CODES,
            f"flash_fwd: one f32/bf16/f16 dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}")
    require(dh in (32, 64), f"flash_fwd: head dim {dh} not in (32, 64)")
    require(b * h <= 65535, f"flash_fwd: B*H={b * h} > 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b == 0:
        return o, lse
    fn = _build.entry("flash_fwd", "flash_fwd", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, h, kvh, t, dh, _build.DTYPE_CODES[q.dtype],
             1.0 / math.sqrt(dh), _build.stream_ptr(q))
    _build.check(err, "flash_fwd")
    fa2_flash_attention_fwd.launches += 1
    return o, lse


def fa2_flash_attention_fwd(q, k, v):
    """Causal FA2 forward on (B, H, T, Dh) q and (B, KVH, T, Dh) k/v ->
    (o, lse).  CUDA tensors launch csrc/flash_fwd.cu (or raise); CPU
    tensors take `_fa2_fwd_plain`."""
    if on_cuda(q, k, v):
        return _fa2_fwd_cuda(q, k, v)
    return _fa2_fwd_plain(q, k, v)


fa2_flash_attention_fwd.launches = 0  # kernel launches (CUDA path only)
