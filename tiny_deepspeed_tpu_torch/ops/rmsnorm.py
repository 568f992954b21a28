# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""RMSNorm, the Llama family's norm: LayerNorm's kernels under an RMS flag.

Counterpart of `tiny_deepspeed_tpu/ops/rmsnorm.py` (the `custom_vjp` at
:52-70 over the plain `rmsnorm_fwd` / `rmsnorm_dx` / `rmsnorm_dw`,
:25-49).  The JAX package has no Pallas kernel for it: XLA fuses the
few elementwise ops and two row reductions.  Eager PyTorch would launch
about eight kernels a norm (and llama-160m's decode tick runs 25 norms),
so on the card RMSNorm takes the C entries LayerNorm has, as the `RMS`
template flag of csrc/ln_fwd.cu and csrc/ln_bwd.cu:

  y    = (x * rstd) * w,   rstd = (mean(x^2, -1) + eps)^-1/2  (f32)
  dx   = rstd*(gy*w) - x * rstd^3 * mean(gy*w*x, -1)
  dw   = sum_rows(gy * x * rstd)

- the forward, `rmsnorm_fwd`, and the residual add fused into it,
  `add_rmsnorm_fwd`: ONE call of the C entry `rms_fwd` (r null or not):
  LayerNorm's forward kernels with no sum of x, no mean and no bias.
  The add variant's sum s is rounded once to x's dtype, bit for bit the
  eager `x + r`;
- the backward, `rmsnorm_bwd`: ONE call of `rms_bwd`, LayerNorm's
  one-pass backward with mean 0 and without db: dx (plus `gs`, rounded
  as autograd's `gs + dx` rounds it) and dw's per-CTA partials folded in
  a fixed order (no atomics: dw is bitwise repeatable).

CUDA tensors launch the entries or raise; CPU tensors take the plain
versions below, copies of the JAX package's functions (statistics in f32,
dx in x's dtype, dw in x's dtype then the weight's).
"""

import ctypes

import torch

from . import _build
from .dispatch import acc_dtype, on_cuda, require
from .layernorm import _BWD_ROWS, _DTYPES, _MAX_N, _empty_rows, _flat_ptr, \
    _rows_ptr


# -- plain versions (the CPU path and the card reference) -------------------

def _rms_fwd_plain(x, w, eps: float = 1e-5):
    """(y, rstd): JAX `rmsnorm_fwd` (:25-30)."""
    acc = acc_dtype(x.dtype)
    xf = x.to(acc)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1) + eps)
    y = xf * rstd[..., None] * w.to(acc)
    return y.to(x.dtype), rstd


def _add_rms_fwd_plain(x, r, w, eps: float = 1e-5):
    s = x + r
    return (s, *_rms_fwd_plain(s, w, eps))


def _rms_dx_plain(gy, x, w, rstd):
    """JAX `rmsnorm_dx` (:33-40), in x's dtype."""
    acc = acc_dtype(x.dtype)
    n = x.shape[-1]
    xf = x.to(acc)
    gyw = gy.to(acc) * w.to(acc)
    r = rstd[..., None]
    c = (gyw * xf).sum(dim=-1, keepdim=True) / n
    return (gyw * r - xf * (r ** 3) * c).to(x.dtype)


def _rms_dw_plain(gy, x, rstd):
    """JAX `rmsnorm_dw` (:43-49): summed over every leading dim, in x's
    dtype."""
    acc = acc_dtype(x.dtype)
    dims = tuple(range(gy.dim() - 1))
    return (gy.to(acc) * x.to(acc) * rstd[..., None]).sum(dim=dims).to(
        x.dtype)


def _rms_bwd_plain(gy, x, w, rstd, gs=None, w_dtype=None):
    """The whole backward: (dx, dw).  dx is `_rms_dx_plain`'s, plus `gs`
    when given (as autograd adds it, in x's dtype); dw `_rms_dw_plain`'s
    cast to w_dtype (default w's), as JAX's rule casts it (:66-67)."""
    w_dtype = w.dtype if w_dtype is None else w_dtype
    dx = _rms_dx_plain(gy, x, w, rstd)
    if gs is not None:
        dx = gs + dx
    return dx, _rms_dw_plain(gy, x, rstd).to(w_dtype)


# -- the C entries (csrc/ln_fwd.cu `rms_fwd`, csrc/ln_bwd.cu `rms_bwd`) -----

# x, r, w, s, y, rstd; sx, sr, rows; n and the two dtype codes; eps; the
# stream
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
# gy, x, gs, w, rstd, dx, pdw, dw; sgy, sx, sgs; rows, n, groups and the
# three dtype codes; the stream
_BWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _fwd_cuda(x, r, w, eps, what):
    """One `rms_fwd` call on the current stream (with r: the residual add
    first): (s or None, y, rstd).  Every operand is checked before
    anything is built; each message is formatted only when its check
    fails."""
    n = x.shape[-1]
    require(x.dtype in _DTYPES, lambda: f"{what}: x must be f32/bf16/f16, "
            f"got {x.dtype}")
    require(0 < n <= _MAX_N, lambda: f"{what}: N={n} not in [1, {_MAX_N}]")
    require(w.shape == (n,) and w.dtype in _DTYPES, lambda: f"{what}: "
            f"weight must be ({n},) in f32/bf16/f16, got {tuple(w.shape)} "
            f"{w.dtype}")
    require(r is None or (r.shape == x.shape and r.dtype == x.dtype),
            lambda: f"{what}: r {tuple(r.shape)} {r.dtype} must match x "
            f"{tuple(x.shape)} {x.dtype}")
    dev = x.device
    require(dev.type == "cuda" and w.device == dev
            and (r is None or r.device == dev),
            lambda: f"{what}: the operands must lie on one CUDA device")
    x2, px, sx = _rows_ptr(x, n)
    r2, pr, sr = (None, None, 0) if r is None else _rows_ptr(r, n)
    rows = x.numel() // n
    y = _empty_rows(x)
    s = None if r is None else _empty_rows(x)
    lead = x.shape[:-1] or ((),)
    rstd = torch.empty(*lead, dtype=torch.float32, device=dev)
    if rows:
        codes = _build.DTYPE_CODES
        err = _build.entry("ln_fwd", "rms_fwd", _FWD_ARGS)(
            px, pr, _flat_ptr(w), None if s is None else s.data_ptr(),
            y.data_ptr(), rstd.data_ptr(), sx, sr, rows, n,
            codes[x.dtype], codes[w.dtype], eps, _build.stream_ptr(x))
        _build.check(err, "rms_fwd")
        (rmsnorm_fwd if r is None else add_rmsnorm_fwd).launches += 1
    return s, y, rstd


def _bwd_cuda(gy, x, w, rstd, gs=None, w_dtype=None):
    """One `rms_bwd` call: both stages, on the current stream."""
    n = x.shape[-1]
    w_dtype = w.dtype if w_dtype is None else w_dtype
    require(x.dtype in _DTYPES and gy.dtype == x.dtype,
            lambda: f"rmsnorm_bwd: x and gy must share one of f32/bf16/f16,"
            f" got {x.dtype}, {gy.dtype}")
    require(gy.shape == x.shape, lambda: f"rmsnorm_bwd: gy "
            f"{tuple(gy.shape)} does not match x {tuple(x.shape)}")
    require(0 < n <= _MAX_N, lambda: f"rmsnorm_bwd: N={n} not in "
            f"[1, {_MAX_N}]")
    require(w.shape == (n,) and w.dtype in _DTYPES,
            lambda: f"rmsnorm_bwd: weight must be ({n},) in f32/bf16/f16, "
            f"got {tuple(w.shape)} {w.dtype}")
    lead = x.shape[:-1]
    require(rstd.shape == lead and rstd.dtype == torch.float32,
            lambda: f"rmsnorm_bwd: rstd must be f32 of shape {tuple(lead)},"
            f" got {tuple(rstd.shape)} {rstd.dtype}")
    require(gs is None or (gs.shape == x.shape and gs.dtype == x.dtype),
            lambda: f"rmsnorm_bwd: gs {tuple(gs.shape)} {gs.dtype} must "
            f"match x {tuple(x.shape)} {x.dtype}")
    require(w_dtype in _DTYPES, lambda: f"rmsnorm_bwd: dw dtype must be "
            f"f32/bf16/f16, got {w_dtype}")
    dev = x.device
    require(dev.type == "cuda" and gy.device == dev and w.device == dev
            and rstd.device == dev and (gs is None or gs.device == dev),
            lambda: "rmsnorm_bwd: the operands must lie on one CUDA device")
    x2, px, sx = _rows_ptr(x, n)
    gy2, pgy, sgy = _rows_ptr(gy, n)
    gs2, pgs, sgs = (None, None, 0) if gs is None else _rows_ptr(gs, n)
    rows = x.numel() // n
    groups = -(-rows // _BWD_ROWS)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    part = torch.empty((groups * n,), dtype=torch.float32, device=dev)
    dw = torch.empty((n,), dtype=w_dtype, device=dev)
    codes = _build.DTYPE_CODES
    err = _build.entry("ln_bwd", "rms_bwd", _BWD_ARGS)(
        pgy, px, pgs, _flat_ptr(w), _flat_ptr(rstd), dx.data_ptr(),
        part.data_ptr(), dw.data_ptr(), sgy, sx, sgs, rows, n, groups,
        codes[x.dtype], codes[w.dtype], codes[w_dtype],
        _build.stream_ptr(x))
    _build.check(err, "rms_bwd")
    rmsnorm_bwd.launches += 1
    if gs is not None:
        rmsnorm_bwd.launches_gs += 1
    return dx, dw


# -- public wrappers --------------------------------------------------------

def rmsnorm_fwd(x, w, eps: float = 1e-5):
    """(y, rstd); rstd is f32 with shape x.shape[:-1].  CUDA tensors
    launch csrc/ln_fwd.cu's RMS kernels (or raise); CPU tensors take
    `_rms_fwd_plain`."""
    if on_cuda(x, w):
        return _fwd_cuda(x, None, w, eps, "rmsnorm_fwd")[1:]
    return _rms_fwd_plain(x, w, eps)


def add_rmsnorm_fwd(x, r, w, eps: float = 1e-5):
    """s = x + r (rounded to x's dtype) and its (y, rstd), as
    `rmsnorm_fwd(x + r, ...)` gives them.  CUDA tensors launch the RMS
    add kernels (or raise); CPU tensors take `_add_rms_fwd_plain`."""
    if on_cuda(x, r, w):
        return _fwd_cuda(x, r, w, eps, "add_rmsnorm_fwd")
    return _add_rms_fwd_plain(x, r, w, eps)


def rmsnorm_bwd(gy, x, w, rstd, gs=None, w_dtype=None):
    """RMSNorm's whole backward from the saved rstd: (dx, dw), dx in x's
    dtype (plus `gs`, the upstream gradient of the norm's input, when
    given), dw in w_dtype (default w's).  CUDA tensors launch
    csrc/ln_bwd.cu's RMS kernels (or raise); CPU tensors take
    `_rms_bwd_plain`."""
    if on_cuda(gy, x, w, rstd, gs):
        return _bwd_cuda(gy, x, w, rstd, gs, w_dtype)
    return _rms_bwd_plain(gy, x, w, rstd, gs, w_dtype)


# kernel launches (CUDA path only); rmsnorm_bwd.launches_gs counts the
# launches among rmsnorm_bwd's that added a `gs`
rmsnorm_fwd.launches = 0
add_rmsnorm_fwd.launches = 0
rmsnorm_bwd.launches = 0
rmsnorm_bwd.launches_gs = 0


class RMSNormFn(torch.autograd.Function):
    """y = rmsnorm(x) * w with the JAX package's vjp rules (`_rms_fwd_rule`
    / `_rms_bwd_rule`, :56-67): the forward saves (x, w, rstd); the
    backward, one `rmsnorm_bwd` call, returns dx in x's dtype and dw
    through x's dtype into w's."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = rmsnorm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(gy, x, w, rstd, None, w.dtype)
        return dx, dw, None


def rmsnorm(x, w, eps: float = 1e-5):
    """y only — the call the model makes, differentiable through
    `RMSNormFn`."""
    return RMSNormFn.apply(x, w, eps)


class AddRMSNormFn(torch.autograd.Function):
    """(s, y) = (x + r, rmsnorm(x + r) * w) in one forward launch.  Saves
    what `RMSNormFn` saves for its input s.  The backward is the
    composition's: s's gradient is g_s plus the norm's dx (autograd's
    accumulation in the compute dtype, which `rmsnorm_bwd` adds in the
    same pass) and flows unchanged to x and r; dw as `RMSNormFn` returns
    it."""

    @staticmethod
    def forward(ctx, x, r, w, eps):
        s, y, rstd = add_rmsnorm_fwd(x, r, w, eps)
        ctx.save_for_backward(s, w, rstd)
        return s, y

    @staticmethod
    def backward(ctx, gs, gy):
        s, w, rstd = ctx.saved_tensors
        d, dw = rmsnorm_bwd(gy, s, w, rstd, gs, w.dtype)
        return d, d, dw, None


def add_rmsnorm(x, r, w, eps: float = 1e-5):
    """(x + r, rmsnorm(x + r)) — the residual add and the next pre-norm in
    one call, differentiable through `AddRMSNormFn`."""
    return AddRMSNormFn.apply(x, r, w, eps)
