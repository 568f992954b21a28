# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""FlashAttention-2, forward and backward: hand-written CUDA kernels on
the card, causal or unmasked.

Replaces the TPU kernels of `tiny_deepspeed_tpu/ops/flash_fa2.py`:

- forward `fa2_flash_attention` (:381) -> `_fwd` (:125, `pallas_call`
  :129): `csrc/flash_fwd.cu`;
- backward `_fa2_bwd` (:410) -> `_bwd` (:302) -> `_dkv_call` (:248,
  `pallas_call` :258) and `_dq_call` (:281, `pallas_call` :285):
  `csrc/flash_bwd.cu`;
- the chunk entries ring attention calls, `fa2_chunk_fwd`, `fa2_chunk_dq`
  and `fa2_chunk_dkv` (:330, :341, :350): the same kernels with a
  `causal` flag.  The ring's diagonal chunk is causal; every other chunk
  it computes lies wholly behind the local queries and runs unmasked.
  The backward chunks take the ring's GLOBAL (merged) lse and di;
- the heads-last entry `fa2_flash_attention_bthd` (:596) on (B, T, H, Dh)
  tensors: its forward (`_fa2_bthd_fwd` :616, `pallas_call` :630) and
  backward (`_fa2_bthd_bwd` :649, `pallas_call`s :668 dk/dv and :685 dq)
  are the same kernels again with a layout flag (`flash_fwd_bthd`,
  `flash_bwd_dq_bthd`, `flash_bwd_dkv_bthd`): rows H*Dh apart instead of
  Dh, same operations in the same order, so bit for bit the
  (B, H, T, Dh) kernels' results on transposed copies.  Causal and MHA
  only, as the JAX entry.  No model path calls it (the JAX model
  transposes and calls `fa2_flash_attention`); its one caller is the A/B
  (`python -m tiny_deepspeed_tpu_torch.fa2_bthd_ab`).  The TPU entry's
  transpose fallback past `_AH_MAX_T_HD` exists for VMEM only and has no
  counterpart: one path serves every size.

Launch counts are per kernel variant: a causal launch, whichever entry
made it, adds to `fa2_flash_attention_fwd` / `_dq` / `_dkv`, an unmasked
one to `fa2_chunk_fwd` / `_dq` / `_dkv`, a heads-last one to
`fa2_flash_attention_bthd_fwd` / `_dq` / `_dkv`.  The counts are kept under a
lock, since ring attention's lockstep test harness launches from several
threads at once.

Design and bound of each kernel are in its source's header.  bf16 and
f16 operands reach the tensor-core (wgmma) forward, dq and dk/dv
kernels; f32 operands reach FP32-FMA kernels.  K/V (and in the dk/dv
pass Q/dO) stream through shared memory in tiles, so any T works
and the TPU package's `FA2_MAX_T` VMEM bound has no counterpart.  Grouped
K/V (KVH | H, query head h reads kv head h // group) run natively, as in
the JAX kernels; dk/dv are summed over each kv head's query-head group and
come back at KVH heads.

`fa2_flash_attention_fwd` returns (o, lse): lse = m + log(l) in f32, the
one fused statistic the backward consumes (p = exp(s - lse), never
stored).  `di = rowsum(do * o)` is an ordinary tensor expression, as in
JAX (:308-309), because no Pallas kernel computes it.  `FA2Fn` ties the
passes into one differentiable op.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build
from .dispatch import acc_dtype, on_cuda, require


def _expand_kv(q, k, v):
    group = q.shape[1] // k.shape[1]
    if group > 1:  # query heads of one group are adjacent
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return k, v


def _causal(t, device):
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def _fa2_fwd_plain(q, k, v, causal=True):
    """The plain PyTorch version: `standard_attention` (JAX
    ops/attention.py:35 — f32 logits, finfo.min causal mask, probs cast to
    the input dtype before PV) plus its row logsumexp; `causal=False`
    masks nothing.  q (B, H, T, Dh); k/v (B, KVH, T, Dh).  Returns (o like
    q, lse (B, H, T) f32)."""
    acc = acc_dtype(q.dtype)
    k, v = _expand_kv(q, k, v)
    t, dh = q.shape[-2], q.shape[-1]
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    logits = logits * (1.0 / math.sqrt(dh))
    if causal:
        logits = logits.masked_fill(~_causal(t, q.device),
                                    torch.finfo(torch.float32).min)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), lse


def _bwd_plain_terms(q, k, v, do, lse, di, causal=True):
    """(p, ds, k, v) over the expanded heads, from the backward's explicit
    formulas in the accumulation type — the same math the kernels run
    (JAX `_bwd_dq_kernel` / `_bwd_dkv_kernel`, :155-245), NOT autograd of
    the forward: s = q k^T scale, p = exp(s - lse) (0 above the diagonal
    when causal), ds = p (do v^T - di) scale."""
    acc = acc_dtype(q.dtype)
    k, v = _expand_kv(q, k, v)
    t, dh = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(acc)[..., None])
    if causal:
        p = p.masked_fill(~_causal(t, q.device), 0.0)
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    ds = p * (dp - di.to(acc)[..., None]) * scale
    return p, ds, k.to(acc), v.to(acc)


def _fa2_dq_plain(q, k, v, do, lse, di, causal=True):
    """dq = ds k, in q's dtype."""
    _, ds, kf, _ = _bwd_plain_terms(q, k, v, do, lse, di, causal)
    return torch.matmul(ds, kf).to(q.dtype)


def _fa2_dkv_plain(q, k, v, do, lse, di, causal=True):
    """(dk, dv) = (ds^T q, p^T do) summed over each kv head's query-head
    group, in k's / v's dtype."""
    p, ds, _, _ = _bwd_plain_terms(q, k, v, do, lse, di, causal)
    acc = p.dtype
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc))
    dv = torch.matmul(p.transpose(-1, -2), do.to(acc))
    b, kvh = k.shape[0], k.shape[1]
    group = q.shape[1] // kvh
    if group > 1:
        dk = dk.reshape(b, kvh, group, *dk.shape[2:]).sum(dim=2)
        dv = dv.reshape(b, kvh, group, *dv.shape[2:]).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _bhtd(*ts):
    """(B, T, H, Dh) tensors -> (B, H, T, Dh) views (and back)."""
    return [t.transpose(1, 2) for t in ts]


def _fa2_bthd_fwd_plain(q, k, v):
    """Heads-last causal forward, plain: transpose, `_fa2_fwd_plain`,
    transpose o back.  Returns (o (B, T, H, Dh), lse (B, H, T) f32)."""
    o, lse = _fa2_fwd_plain(*_bhtd(q, k, v))
    return o.transpose(1, 2), lse


def _fa2_bthd_dq_plain(q, k, v, do, lse, di):
    """Heads-last dq, plain: `_fa2_dq_plain` on the transposes."""
    return _fa2_dq_plain(*_bhtd(q, k, v, do), lse, di).transpose(1, 2)


def _fa2_bthd_dkv_plain(q, k, v, do, lse, di):
    """Heads-last (dk, dv), plain: `_fa2_dkv_plain` on the transposes."""
    dk, dv = _fa2_dkv_plain(*_bhtd(q, k, v, do), lse, di)
    return dk.transpose(1, 2), dv.transpose(1, 2)


# -- the CUDA kernels --------------------------------------------------------

_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_DQ_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                         ctypes.c_void_p]
_DKV_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_FWD_BTHD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
_DQ_BTHD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
_DKV_BTHD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
_COUNT_LOCK = threading.Lock()


def _count(entry):
    """One launch of the kernel variant whose wrapper is `entry`."""
    with _COUNT_LOCK:
        entry.launches += 1


def _check_qkv(what, q, k, v):
    """Validate q (B,H,T,Dh), k/v (B,KVH,T,Dh) for a kernel; returns
    (b, h, kvh, t, dh)."""
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            f"{what}: q (B,H,T,Dh), k/v (B,KVH,T,Dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, dh = q.shape
    kvh = k.shape[1]
    require(k.shape[0] == b and k.shape[2] == t and k.shape[3] == dh
            and kvh >= 1 and h % kvh == 0,
            f"{what}: k/v {tuple(k.shape)} do not group q {tuple(q.shape)}")
    require(q.dtype == k.dtype == v.dtype
            and q.dtype in _build.DTYPE_CODES,
            f"{what}: one f32/bf16/f16 dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}")
    require(dh in (32, 64), f"{what}: head dim {dh} not in (32, 64)")
    require(b * h <= 65535, f"{what}: B*H={b * h} > 65535")
    return b, h, kvh, t, dh


def _check_bwd(what, q, k, v, do, lse, di):
    b, h, kvh, t, dh = _check_qkv(what, q, k, v)
    require(do.shape == q.shape and do.dtype == q.dtype,
            f"{what}: do {tuple(do.shape)} {do.dtype} must match q "
            f"{tuple(q.shape)} {q.dtype}")
    for name, s in (("lse", lse), ("di", di)):
        require(tuple(s.shape) == (b, h, t) and s.dtype == torch.float32,
                f"{what}: {name} must be f32 (B, H, T) = {(b, h, t)}, got "
                f"{tuple(s.shape)} {s.dtype}")
    return b, h, kvh, t, dh


def _aligned(t):
    """t contiguous with its data on a 16-byte boundary: the tensor-core
    kernels copy rows into shared memory 16 bytes at a time, and a view's
    storage offset can leave a contiguous tensor off that boundary (then
    it is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fa2_fwd_cuda(q, k, v, causal=True):
    b, h, kvh, t, dh = _check_qkv("flash_fwd", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b == 0:
        return o, lse
    fn = _build.entry("flash_fwd", "flash_fwd", _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, h, kvh, t, dh, _build.DTYPE_CODES[q.dtype],
             int(causal), 1.0 / math.sqrt(dh), _build.stream_ptr(q))
    _build.check(err, "flash_fwd")
    _count(fa2_flash_attention_fwd if causal else fa2_chunk_fwd)
    return o, lse


def _bwd_operands(q, k, v, do, lse, di):
    return (_aligned(q), _aligned(k), _aligned(v), _aligned(do),
            lse.contiguous(), di.contiguous())


def _fa2_dq_cuda(q, k, v, do, lse, di, causal=True):
    b, h, kvh, t, dh = _check_bwd("flash_bwd_dq", q, k, v, do, lse, di)
    q, k, v, do, lse, di = _bwd_operands(q, k, v, do, lse, di)
    dq = torch.empty_like(q)
    if t == 0 or b == 0:
        return dq
    fn = _build.entry("flash_bwd", "flash_bwd_dq", _DQ_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, h, kvh, t, dh,
             _build.DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(dh),
             _build.stream_ptr(q))
    _build.check(err, "flash_bwd_dq")
    _count(fa2_flash_attention_dq if causal else fa2_chunk_dq)
    return dq


def _fa2_dkv_cuda(q, k, v, do, lse, di, causal=True):
    b, h, kvh, t, dh = _check_bwd("flash_bwd_dkv", q, k, v, do, lse, di)
    q, k, v, do, lse, di = _bwd_operands(q, k, v, do, lse, di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if t == 0 or b == 0:
        return dk, dv
    fn = _build.entry("flash_bwd", "flash_bwd_dkv", _DKV_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, kvh, t, dh, _build.DTYPE_CODES[q.dtype], int(causal),
             1.0 / math.sqrt(dh), _build.stream_ptr(q))
    _build.check(err, "flash_bwd_dkv")
    _count(fa2_flash_attention_dkv if causal else fa2_chunk_dkv)
    return dk, dv


def _check_mha(what, q, k, v):
    """Heads-last q/k/v must share one (B, T, H, Dh) shape: MHA only, as
    the JAX entry (its kernels index k/v with q's head)."""
    require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
            f"{what}: q/k/v (B, T, H, Dh) of one shape (MHA), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _check_bthd(what, q, k, v, do=None, lse=None, di=None):
    """Validate heads-last operands for a kernel; returns (b, h, t, dh)."""
    _check_mha(what, q, k, v)
    b, t, h, dh = q.shape
    _check_qkv(what, *_bhtd(q, k, v))
    if do is not None:
        require(do.shape == q.shape and do.dtype == q.dtype,
                f"{what}: do {tuple(do.shape)} {do.dtype} must match q")
        for name, s in (("lse", lse), ("di", di)):
            require(tuple(s.shape) == (b, h, t)
                    and s.dtype == torch.float32,
                    f"{what}: {name} must be f32 (B, H, T) = {(b, h, t)}, "
                    f"got {tuple(s.shape)} {s.dtype}")
    return b, h, t, dh


def _fa2_bthd_fwd_cuda(q, k, v):
    b, h, t, dh = _check_bthd("flash_fwd_bthd", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b == 0:
        return o, lse
    fn = _build.entry("flash_fwd", "flash_fwd_bthd", _FWD_BTHD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, h, h, t, dh, _build.DTYPE_CODES[q.dtype],
             1.0 / math.sqrt(dh), _build.stream_ptr(q))
    _build.check(err, "flash_fwd_bthd")
    _count(fa2_flash_attention_bthd_fwd)
    return o, lse


def _fa2_bthd_dq_cuda(q, k, v, do, lse, di):
    b, h, t, dh = _check_bthd("flash_bwd_dq_bthd", q, k, v, do, lse, di)
    q, k, v, do, lse, di = _bwd_operands(q, k, v, do, lse, di)
    dq = torch.empty_like(q)
    if t == 0 or b == 0:
        return dq
    fn = _build.entry("flash_bwd", "flash_bwd_dq_bthd", _DQ_BTHD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, h, h, t, dh,
             _build.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh),
             _build.stream_ptr(q))
    _build.check(err, "flash_bwd_dq_bthd")
    _count(fa2_flash_attention_bthd_dq)
    return dq


def _fa2_bthd_dkv_cuda(q, k, v, do, lse, di):
    b, h, t, dh = _check_bthd("flash_bwd_dkv_bthd", q, k, v, do, lse, di)
    q, k, v, do, lse, di = _bwd_operands(q, k, v, do, lse, di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if t == 0 or b == 0:
        return dk, dv
    fn = _build.entry("flash_bwd", "flash_bwd_dkv_bthd", _DKV_BTHD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, h, t, dh, _build.DTYPE_CODES[q.dtype],
             1.0 / math.sqrt(dh), _build.stream_ptr(q))
    _build.check(err, "flash_bwd_dkv_bthd")
    _count(fa2_flash_attention_bthd_dkv)
    return dk, dv


# -- public wrappers ---------------------------------------------------------

def fa2_flash_attention_fwd(q, k, v):
    """Causal FA2 forward on (B, H, T, Dh) q and (B, KVH, T, Dh) k/v ->
    (o, lse).  CUDA tensors launch csrc/flash_fwd.cu (or raise); CPU
    tensors take `_fa2_fwd_plain`."""
    if on_cuda(q, k, v):
        return _fa2_fwd_cuda(q, k, v)
    return _fa2_fwd_plain(q, k, v)


def fa2_flash_attention_dq(q, k, v, do, lse, di):
    """dq of causal attention from the forward's lse and di = rowsum(do*o)
    (both f32 (B, H, T)).  CUDA tensors launch csrc/flash_bwd.cu's dq pass
    (or raise); CPU tensors take `_fa2_dq_plain`."""
    if on_cuda(q, k, v, do, lse, di):
        return _fa2_dq_cuda(q, k, v, do, lse, di)
    return _fa2_dq_plain(q, k, v, do, lse, di)


def fa2_flash_attention_dkv(q, k, v, do, lse, di):
    """(dk, dv) at KVH heads, as `fa2_flash_attention_dq`.  CUDA tensors
    launch csrc/flash_bwd.cu's dk/dv pass (or raise); CPU tensors take
    `_fa2_dkv_plain`."""
    if on_cuda(q, k, v, do, lse, di):
        return _fa2_dkv_cuda(q, k, v, do, lse, di)
    return _fa2_dkv_plain(q, k, v, do, lse, di)


def fa2_chunk_fwd(q, k, v, *, causal: bool):
    """One ring attention chunk (JAX :330): attention of the local queries
    over one K/V chunk of the same length, causal (the diagonal chunk) or
    unmasked (a chunk wholly behind the queries) -> (o normalized within
    the chunk, lse (B, H, T) f32).  K/V stay at KVH heads, as the ring
    rotates them.  CUDA tensors launch csrc/flash_fwd.cu (or raise); CPU
    tensors take `_fa2_fwd_plain`."""
    if on_cuda(q, k, v):
        return _fa2_fwd_cuda(q, k, v, causal)
    return _fa2_fwd_plain(q, k, v, causal)


def fa2_chunk_dq(q, k, v, do, lse, di, *, causal: bool):
    """dq of one chunk from the GLOBAL (merged) lse and di (JAX :341).
    CUDA tensors launch csrc/flash_bwd.cu's dq pass (or raise); CPU
    tensors take `_fa2_dq_plain`."""
    if on_cuda(q, k, v, do, lse, di):
        return _fa2_dq_cuda(q, k, v, do, lse, di, causal)
    return _fa2_dq_plain(q, k, v, do, lse, di, causal)


def fa2_chunk_dkv(q, k, v, do, lse, di, *, causal: bool):
    """(dk, dv) of one chunk at KVH heads from the GLOBAL lse and di (JAX
    :350).  CUDA tensors launch csrc/flash_bwd.cu's dk/dv pass (or
    raise); CPU tensors take `_fa2_dkv_plain`."""
    if on_cuda(q, k, v, do, lse, di):
        return _fa2_dkv_cuda(q, k, v, do, lse, di, causal)
    return _fa2_dkv_plain(q, k, v, do, lse, di, causal)


def fa2_flash_attention_bthd_fwd(q, k, v):
    """Causal FA2 forward on heads-last (B, T, H, Dh) q/k/v (MHA) -> (o
    (B, T, H, Dh), lse (B, H, T) f32).  CUDA tensors launch
    csrc/flash_fwd.cu's `flash_fwd_bthd` (or raise); CPU tensors take
    `_fa2_bthd_fwd_plain`."""
    if on_cuda(q, k, v):
        return _fa2_bthd_fwd_cuda(q, k, v)
    _check_mha("flash_fwd_bthd", q, k, v)
    return _fa2_bthd_fwd_plain(q, k, v)


def fa2_flash_attention_bthd_dq(q, k, v, do, lse, di):
    """Heads-last dq from the forward's lse and di (f32 (B, H, T)).  CUDA
    tensors launch `flash_bwd_dq_bthd` (or raise); CPU tensors take
    `_fa2_bthd_dq_plain`."""
    if on_cuda(q, k, v, do, lse, di):
        return _fa2_bthd_dq_cuda(q, k, v, do, lse, di)
    _check_mha("flash_bwd_dq_bthd", q, k, v)
    return _fa2_bthd_dq_plain(q, k, v, do, lse, di)


def fa2_flash_attention_bthd_dkv(q, k, v, do, lse, di):
    """Heads-last (dk, dv), as `fa2_flash_attention_bthd_dq`.  CUDA
    tensors launch `flash_bwd_dkv_bthd` (or raise); CPU tensors take
    `_fa2_bthd_dkv_plain`."""
    if on_cuda(q, k, v, do, lse, di):
        return _fa2_bthd_dkv_cuda(q, k, v, do, lse, di)
    _check_mha("flash_bwd_dkv_bthd", q, k, v)
    return _fa2_bthd_dkv_plain(q, k, v, do, lse, di)


# kernel launches (CUDA path only): causal variants, unmasked variants,
# heads-last variants
fa2_flash_attention_bthd_fwd.launches = 0
fa2_flash_attention_bthd_dq.launches = 0
fa2_flash_attention_bthd_dkv.launches = 0
fa2_flash_attention_fwd.launches = 0
fa2_flash_attention_dq.launches = 0
fa2_flash_attention_dkv.launches = 0
fa2_chunk_fwd.launches = 0
fa2_chunk_dq.launches = 0
fa2_chunk_dkv.launches = 0


class FA2Fn(torch.autograd.Function):
    """Causal attention with the JAX package's FA2 vjp (`_fa2_fwd` /
    `_fa2_bwd`, :396-426): the forward saves (q, k, v, o, lse); the
    backward computes di = rowsum(do * o) in f32, then the dq and dk/dv
    passes."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = fa2_flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = (do.to(lse.dtype) * o.to(lse.dtype)).sum(dim=-1)
        dq = fa2_flash_attention_dq(q, k, v, do, lse, di)
        dk, dv = fa2_flash_attention_dkv(q, k, v, do, lse, di)
        return dq, dk, dv


class FA2BthdFn(torch.autograd.Function):
    """Causal attention on heads-last (B, T, H, Dh) tensors with the JAX
    entry's vjp (`_fa2_bthd_fwd` / `_fa2_bthd_bwd`, :616-699): the forward
    saves (q, k, v, o, lse); the backward computes di = rowsum(do * o) in
    f32 as a tensor expression, (B, T, H) -> (B, H, T) (JAX :664-665),
    then the dk/dv and dq passes."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = fa2_flash_attention_bthd_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = (do.to(lse.dtype) * o.to(lse.dtype)).sum(dim=-1).transpose(
            1, 2).contiguous()
        dk, dv = fa2_flash_attention_bthd_dkv(q, k, v, do, lse, di)
        dq = fa2_flash_attention_bthd_dq(q, k, v, do, lse, di)
        return dq, dk, dv


def fa2_flash_attention_bthd(q, k, v, block_q: int = 512,
                             block_k: int = 512):
    """Causal FA2 on heads-last (B, T, H, Dh) q/k/v (MHA), differentiable
    — the JAX entry's signature (:596).  `block_q` / `block_k` are the
    TPU kernel's VMEM tiling hints; the Hopper kernels tile with their own
    constants (csrc/flash_fwd.cu, csrc/flash_bwd.cu), so they are
    accepted and ignored.  Returns o (B, T, H, Dh)."""
    del block_q, block_k
    return FA2BthdFn.apply(q, k, v)
