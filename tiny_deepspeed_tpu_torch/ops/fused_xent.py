# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Fused lm_head + softmax cross-entropy: hand-written CUDA kernels on the
card, the logits never materialized.

Replaces the TPU kernels of `tiny_deepspeed_tpu/ops/xent_pallas.py`:

- forward `pallas_fused_xent` (:267) -> `_fwd` (:115, `pallas_call`
  :120): `fused_xent_fwd` -> (loss_vec, lse), both f32 (S,);
- backward `_bwd` (:212): the dx pass (`pallas_call` :218) and the dW
  pass (`pallas_call` :235): `fused_xent_dx`, `fused_xent_dw`.

All three are `csrc/fused_xent.cu` (design and bound in its header).
`FusedXentFn` / `pallas_fused_xent` tie them into the JAX `custom_vjp`
(`_pfx_fwd` / `_pfx_bwd`, :290-312): x is (B, T, D) or (S, D); the
forward saves lse; the backward's gscale = g / S; dx comes back in x's
dtype, dW in f32 and then cast to w's dtype; targets get no gradient.

No dispatch gate.  The JAX entry falls back to the chunked XLA path when
S has no 8-aligned token block (`viable_token_block`, :65-73) because a
single (S, D) block would not fit the TPU's VMEM.  The CUDA kernels
mask ragged token and vocab tiles, so they take any S and V: the port
has neither the gate nor the fallback.

Operands: D a multiple of 32; x and w one of f32 / bf16 / f16.  The
kernels read w as a contiguous (D, V) row-major matrix: a transposed
view (`wte.t()` under `tie_weights`) is copied to that layout by the
wrapper, once per call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import acc_dtype, on_cuda, require

_PLAIN_ROWS = 1024  # token block of the plain versions' (rows, V) logits


# -- plain versions (the CPU path and the card reference) -------------------

def _logit_blocks(x, w):
    """(s0, x block in the accumulation type, z = x_blk @ w) per block of
    _PLAIN_ROWS tokens: the plain versions never hold all (S, V) logits."""
    acc = acc_dtype(x.dtype)
    wf = w.to(acc)
    for s0 in range(0, x.shape[0], _PLAIN_ROWS):
        xb = x[s0:s0 + _PLAIN_ROWS].to(acc)
        yield s0, xb, xb @ wf


def _onehot_hit(z, tgt):
    """Boolean (rows, V): column == target (no hit for targets outside
    [0, V), as the kernel's column match)."""
    cols = torch.arange(z.shape[1], device=z.device)
    return cols[None, :] == tgt.long()[:, None]


def _xent_fwd_plain(x, w, targets):
    """x (S, D), w (D, V), targets (S,) -> (loss_vec, lse), f32 (S,):
    lse = logsumexp(x w), loss = lse - (x w)[target] (the gold logit by
    column match, 0 for an out-of-range target)."""
    s = x.shape[0]
    acc = acc_dtype(x.dtype)
    loss = torch.empty(s, dtype=acc, device=x.device)
    lse = torch.empty(s, dtype=acc, device=x.device)
    for s0, _, z in _logit_blocks(x, w):
        tb = targets[s0:s0 + z.shape[0]]
        lz = torch.logsumexp(z, dim=-1)
        gold = torch.where(_onehot_hit(z, tb), z, 0.0).sum(dim=-1)
        lse[s0:s0 + z.shape[0]] = lz
        loss[s0:s0 + z.shape[0]] = lz - gold
    return loss, lse


def _tile_dz(z, tb, lse_b, gscale):
    """dz = (exp(z - lse) - onehot) * gscale, in z's type (JAX
    `_tile_dz`, :150-168)."""
    p = torch.exp(z - lse_b.to(z.dtype)[:, None])
    p = torch.where(_onehot_hit(z, tb), p - 1.0, p)
    return p * gscale


def _xent_dx_plain(x, w, targets, lse, gscale):
    """dx = dz w^T in the accumulation type, returned in x's dtype."""
    out = torch.empty_like(x)
    wf = w.to(acc_dtype(x.dtype))
    for s0, _, z in _logit_blocks(x, w):
        n = z.shape[0]
        dz = _tile_dz(z, targets[s0:s0 + n], lse[s0:s0 + n], gscale)
        out[s0:s0 + n] = (dz @ wf.t()).to(x.dtype)
    return out


def _xent_dw_plain(x, w, targets, lse, gscale):
    """dW = x^T dz, (D, V) in the accumulation type (f32)."""
    acc = acc_dtype(x.dtype)
    dw = torch.zeros(w.shape, dtype=acc, device=x.device)
    for s0, xb, z in _logit_blocks(x, w):
        n = z.shape[0]
        dz = _tile_dz(z, targets[s0:s0 + n], lse[s0:s0 + n], gscale)
        dw += xb.t() @ dz
    return dw


# -- the CUDA kernels --------------------------------------------------------

_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _aligned(t):
    """Contiguous, with a 16-byte-aligned start (the kernels' vector
    loads); copies only a view that is neither."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _operands(what, x, w, targets, lse=None, gscale=None):
    """Validate for a kernel; returns (x, w, targets int32, lse, gscale)
    as the kernels read them."""
    require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
            f"{what}: x (S, D), w (D, V); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}")
    s, d = x.shape
    require(x.dtype == w.dtype and x.dtype in _build.DTYPE_CODES,
            f"{what}: x and w one f32/bf16/f16 dtype, got {x.dtype}, "
            f"{w.dtype}")
    require(d % 32 == 0, f"{what}: D={d} must be a multiple of 32")
    require(tuple(targets.shape) == (s,) and not targets.is_floating_point(),
            f"{what}: targets must be integer ({s},), got "
            f"{tuple(targets.shape)} {targets.dtype}")
    if lse is not None:
        require(tuple(lse.shape) == (s,) and lse.dtype == torch.float32,
                f"{what}: lse must be f32 ({s},), got {tuple(lse.shape)} "
                f"{lse.dtype}")
        require(gscale.numel() == 1 and gscale.dtype == torch.float32,
                f"{what}: gscale must be one f32, got "
                f"{tuple(gscale.shape)} {gscale.dtype}")
        lse, gscale = _aligned(lse), _aligned(gscale.reshape(1))
    return (_aligned(x), _aligned(w), targets.to(torch.int32).contiguous(),
            lse, gscale)


def _fwd_cuda(x, w, targets):
    x, w, tg, _, _ = _operands("fused_xent_fwd", x, w, targets)
    (s, d), v = x.shape, w.shape[1]
    loss = torch.empty(s, dtype=torch.float32, device=x.device)
    lse = torch.empty(s, dtype=torch.float32, device=x.device)
    if s == 0 or v == 0:
        return loss, lse
    fn = _build.entry("fused_xent", "fused_xent_fwd", _FWD_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), tg.data_ptr(), loss.data_ptr(),
             lse.data_ptr(), s, d, v, _build.DTYPE_CODES[x.dtype],
             _build.stream_ptr(x))
    _build.check(err, "fused_xent_fwd")
    fused_xent_fwd.launches += 1
    return loss, lse


def _dx_cuda(x, w, targets, lse, gscale):
    x, w, tg, lse, gs = _operands("fused_xent_dx", x, w, targets, lse,
                                  gscale)
    (s, d), v = x.shape, w.shape[1]
    dx = torch.empty_like(x)
    if s == 0:
        return dx
    if v == 0:
        return dx.zero_()
    fn = _build.entry("fused_xent", "fused_xent_dx", _BWD_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), tg.data_ptr(), lse.data_ptr(),
             gs.data_ptr(), dx.data_ptr(), s, d, v,
             _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(err, "fused_xent_dx")
    fused_xent_dx.launches += 1
    return dx


def _dw_cuda(x, w, targets, lse, gscale):
    x, w, tg, lse, gs = _operands("fused_xent_dw", x, w, targets, lse,
                                  gscale)
    (s, d), v = x.shape, w.shape[1]
    dw = torch.empty((d, v), dtype=torch.float32, device=x.device)
    if v == 0:
        return dw
    if s == 0:
        return dw.zero_()
    fn = _build.entry("fused_xent", "fused_xent_dw", _BWD_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), tg.data_ptr(), lse.data_ptr(),
             gs.data_ptr(), dw.data_ptr(), s, d, v,
             _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(err, "fused_xent_dw")
    fused_xent_dw.launches += 1
    return dw


# -- public wrappers ---------------------------------------------------------

def fused_xent_fwd(x, w, targets):
    """x (S, D), w (D, V), targets (S,) -> (loss_vec, lse), f32 (S,).
    CUDA tensors launch csrc/fused_xent.cu's forward (or raise); CPU
    tensors take `_xent_fwd_plain`."""
    if on_cuda(x, w, targets):
        return _fwd_cuda(x, w, targets)
    return _xent_fwd_plain(x, w, targets)


def fused_xent_dx(x, w, targets, lse, gscale):
    """dx (S, D) in x's dtype from the forward's lse and gscale (the
    upstream gradient over S, one f32 tensor).  CUDA tensors launch the
    dx pass (or raise); CPU tensors take `_xent_dx_plain`."""
    if on_cuda(x, w, targets, lse, gscale):
        return _dx_cuda(x, w, targets, lse, gscale)
    return _xent_dx_plain(x, w, targets, lse, gscale)


def fused_xent_dw(x, w, targets, lse, gscale):
    """dW (D, V) f32, as `fused_xent_dx`.  CUDA tensors launch the dW
    pass (or raise); CPU tensors take `_xent_dw_plain`."""
    if on_cuda(x, w, targets, lse, gscale):
        return _dw_cuda(x, w, targets, lse, gscale)
    return _xent_dw_plain(x, w, targets, lse, gscale)


# kernel launches (CUDA path only)
fused_xent_fwd.launches = 0
fused_xent_dx.launches = 0
fused_xent_dw.launches = 0


class FusedXentFn(torch.autograd.Function):
    """Mean NLL of logits = x @ w with the JAX package's vjp (`_pfx_fwd` /
    `_pfx_bwd`, xent_pallas.py:290-312)."""

    @staticmethod
    def forward(ctx, x, w, targets):
        d = x.shape[-1]
        xf, tf = x.reshape(-1, d), targets.reshape(-1)
        loss_vec, lse = fused_xent_fwd(xf, w, tf)
        ctx.save_for_backward(x, w, targets, lse)
        return loss_vec.sum() / xf.shape[0]

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        d = x.shape[-1]
        xf, tf = x.reshape(-1, d), targets.reshape(-1)
        gscale = (g / xf.shape[0]).to(lse.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fused_xent_dx(xf, w, tf, lse, gscale).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = fused_xent_dw(xf, w, tf, lse, gscale).to(w.dtype)
        return dx, dw, None


def pallas_fused_xent(x, w, targets):
    """Mean NLL of logits = x @ w, logits never materialized (the JAX
    entry's name).  x (B, T, D) or (S, D); w (D, V); targets matching
    x's leading dims."""
    return FusedXentFn.apply(x, w, targets)
