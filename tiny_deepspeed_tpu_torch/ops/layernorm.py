# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""LayerNorm forward and backward: hand-written kernels on the card.

Counterpart of `tiny_deepspeed_tpu/ops/layernorm.py` (the `custom_vjp` at
:147-167) and of its three Pallas kernels in `ops/layernorm_pallas.py`:

- forward `ln_fwd_pallas` (:78, `pallas_call` :87) -> (y, mean, rstd);
  also with the residual add before it fused in (`add_layernorm_fwd`,
  below: the JAX package adds, then norms);
- `ln_dx_pallas` (:132, `pallas_call` :139): per-row input gradient
  dx = rstd * (gy*w - mean(gy*w) - xhat * mean(gy*w*xhat));
- `ln_dwdb_pallas` (:185, `pallas_call` :191): dw = sum_rows gy*xhat,
  db = sum_rows gy, accumulated in f32.

The Pallas kernels tile rows into VMEM blocks that must divide the row
count (:41-58, with an XLA fallback).  On Hopper that tiling buys
nothing, and no divisibility fallback exists here:

- fwd and dx: one program owns one row.  N (768 on gpt2-124m) fits one
  power-of-two block, so each input is read once and each output written
  once.  Both are bound by those bytes (a few flops per element against
  the card's ~300 flop/byte balance point); the kernels move nothing else
  but the 8-byte (mean, rstd) per row.
- add + fwd: every pre-LN norm but the first reads a residual sum made
  one launch earlier (`x + r`).  At serving's few rows both launches sit
  at a launch's own floor, so the sum is made inside the forward's
  program: it loads a row of x and of r, adds in f32, rounds once to x's
  dtype (RTNE, as PyTorch's eager `x + r` rounds), stores that sum s and
  runs the forward's body on it.  s, y, mean and rstd are bit for bit
  `x + r` followed by the forward kernel (same body, same block, same
  warps: the same reduction order).
- the backward, `layernorm_bwd`: `ln_dx_pallas` and `ln_dwdb_pallas` in
  ONE pass over gy and x (csrc/ln_bwd.cu, CUDA C++ behind one ctypes
  call): a warp owns a row at a time and its lanes own the same columns
  in every row, so the row sums that dx needs and the column sums of dw
  and db come from the same loads; a CTA's column sums land in an f32
  (G, N) partials buffer (G = ceil(rows / 64), fixed by the shape) and
  a second kernel folds the G partials per column in ascending order.
  No float atomics: dw and db are bit-for-bit repeatable, run to run.
  With `gs` (AddLayerNormFn: the upstream gradient of s = x + r) the
  kernel stores gs + dx, rounded as autograd's `gs + dx` rounds it.
- the Triton pair it replaced stays behind the public `layernorm_dx` /
  `layernorm_dwdb` (the counterparts of JAX's two functions, and the
  parent arm of chip_smoke.py's comparisons): `_ln_dx_kernel`, one
  program a row, and `_ln_dwdb_partial_kernel` + `_ln_dwdb_final_kernel`
  (the reference's two-stage decomposition, layernorm_pallas.py:16-21,
  as Hopper runs blocks in no order).  No training path launches them.

Numerics follow the JAX package's XLA versions (`_ln_fwd_xla`,
`_ln_dx_xla`, `_ln_dwdb_xla`, :71-134): statistics in f32 with
var = E[x^2] - mean^2; dx in x's dtype; dw/db emitted in x's dtype, then
cast to the weight's dtype by the backward rule (:158-164; the port
casts db to the bias's dtype).

This module must import without triton: `triton` is imported, and the
kernels defined, inside the function that first launches one.  It also
avoids `from __future__ import annotations`, so the kernels'
`tl.constexpr` annotations are real objects when Triton reads them.
"""

import ctypes
import types

import torch

from . import _build
from .dispatch import acc_dtype, on_cuda, require

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_N = 16384  # one row per program holds the whole row in registers


# -- plain versions (the CPU path and the card reference) -------------------

def _ln_fwd_plain(x, w, b, eps: float = 1e-5):
    acc = acc_dtype(x.dtype)
    xf = x.to(acc)
    mean = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean[..., None]) * rstd[..., None]
    y = y * w.to(acc) + b.to(acc)
    return y.to(x.dtype), mean, rstd


def _add_ln_fwd_plain(x, r, w, b, eps: float = 1e-5):
    s = x + r
    return (s, *_ln_fwd_plain(s, w, b, eps))


def _ln_dx_plain(gy, x, w, mean, rstd):
    """Copy of the JAX `_ln_dx_xla` (ops/layernorm.py:102-111)."""
    acc = acc_dtype(x.dtype)
    n = x.shape[-1]
    xhat = (x.to(acc) - mean[..., None]) * rstd[..., None]
    dxhat = gy.to(acc) * w.to(acc)
    c1 = dxhat.sum(dim=-1, keepdim=True) / n
    c2 = (dxhat * xhat).sum(dim=-1, keepdim=True) / n
    return ((dxhat - c1 - xhat * c2) * rstd[..., None]).to(x.dtype)


def _ln_dwdb_plain(gy, x, mean, rstd):
    """Copy of the JAX `_ln_dwdb_xla` (ops/layernorm.py:127-134): sums
    over every leading dim, returned in x's dtype."""
    acc = acc_dtype(x.dtype)
    xhat = (x.to(acc) - mean[..., None]) * rstd[..., None]
    gyf = gy.to(acc)
    dims = tuple(range(gy.dim() - 1))
    return (gyf * xhat).sum(dim=dims).to(x.dtype), \
        gyf.sum(dim=dims).to(x.dtype)


def _ln_bwd_plain(gy, x, w, mean, rstd, gs=None, w_dtype=None,
                  b_dtype=None):
    """The whole backward: (dx, dw, db).  dx is `_ln_dx_plain`'s, plus
    `gs` when given (as autograd adds it, in x's dtype); dw, db are
    `_ln_dwdb_plain`'s cast to w_dtype (default w's) and b_dtype (default
    w_dtype's, as JAX's rule casts both to w's dtype)."""
    w_dtype = w.dtype if w_dtype is None else w_dtype
    b_dtype = w_dtype if b_dtype is None else b_dtype
    dx = _ln_dx_plain(gy, x, w, mean, rstd)
    if gs is not None:
        dx = gs + dx
    dw, db = _ln_dwdb_plain(gy, x, mean, rstd)
    return dx, dw.to(w_dtype), db.to(b_dtype)


# -- the Triton kernels -----------------------------------------------------

_KERNELS = None


def _triton_kernels():
    """Define (once) and return the @triton.jit kernels."""
    global _KERNELS, tl
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd_kernel(X, W, B, Y, Mean, Rstd, stride_x, stride_y, N,
                       eps, BLOCK_N: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_N)
        m = cols < N
        x = tl.load(X + row * stride_x + cols, mask=m, other=0.0)
        x = x.to(tl.float32)
        mean = tl.sum(x, axis=0) / N
        var = tl.sum(x * x, axis=0) / N - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(W + cols, mask=m, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=m, other=0.0).to(tl.float32)
        y = (x - mean) * rstd * w + b
        tl.store(Y + row * stride_y + cols, y.to(Y.dtype.element_ty),
                 mask=m)
        tl.store(Mean + row, mean)
        tl.store(Rstd + row, rstd)

    @triton.jit
    def _add_ln_fwd_kernel(X, R, W, B, S, Y, Mean, Rstd, N, eps,
                           BLOCK_N: tl.constexpr):
        # rows are contiguous: the row stride is N (no stride arguments:
        # each one costs Triton's launcher host time on the serving tick)
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_N)
        m = cols < N
        x = tl.load(X + row * N + cols, mask=m, other=0.0)
        r = tl.load(R + row * N + cols, mask=m, other=0.0)
        # the sum rounded once to the tensors' dtype, as `x + r` rounds it
        s = (x.to(tl.float32) + r.to(tl.float32)).to(S.dtype.element_ty)
        tl.store(S + row * N + cols, s, mask=m)
        x = s.to(tl.float32)
        # from here on `_ln_fwd_kernel`'s body, verbatim
        mean = tl.sum(x, axis=0) / N
        var = tl.sum(x * x, axis=0) / N - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(W + cols, mask=m, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=m, other=0.0).to(tl.float32)
        y = (x - mean) * rstd * w + b
        tl.store(Y + row * N + cols, y.to(Y.dtype.element_ty), mask=m)
        tl.store(Mean + row, mean)
        tl.store(Rstd + row, rstd)

    @triton.jit
    def _ln_dx_kernel(GY, X, W, Mean, Rstd, DX, N, BLOCK_N: tl.constexpr):
        # rows are contiguous: the row stride is N
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_N)
        m = cols < N
        x = tl.load(X + row * N + cols, mask=m, other=0.0).to(tl.float32)
        gy = tl.load(GY + row * N + cols, mask=m, other=0.0).to(tl.float32)
        w = tl.load(W + cols, mask=m, other=0.0).to(tl.float32)
        mean = tl.load(Mean + row)
        rstd = tl.load(Rstd + row)
        xhat = tl.where(m, (x - mean) * rstd, 0.0)
        dxhat = gy * w  # 0 past N: gy and w load as 0 there
        c1 = tl.sum(dxhat, axis=0) / N
        c2 = tl.sum(dxhat * xhat, axis=0) / N
        dx = (dxhat - c1 - xhat * c2) * rstd
        tl.store(DX + row * N + cols, dx.to(DX.dtype.element_ty), mask=m)

    @triton.jit
    def _ln_dwdb_partial_kernel(GY, X, Mean, Rstd, PDW, PDB, rows, N,
                                rows_per, BLOCK_R: tl.constexpr,
                                BLOCK_N: tl.constexpr):
        # stage 1: program (g, c) sums rows [g*rows_per, (g+1)*rows_per)
        # of column block c into partials row g
        g = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
        cm = cols < N
        r0 = g * rows_per
        r_end = tl.minimum(r0 + rows_per, rows)
        acc_w = tl.zeros((BLOCK_R, BLOCK_N), dtype=tl.float32)
        acc_b = tl.zeros((BLOCK_R, BLOCK_N), dtype=tl.float32)
        for i in range(0, rows_per, BLOCK_R):
            r = r0 + i + tl.arange(0, BLOCK_R)
            rm = r < r_end
            off = r.to(tl.int64)[:, None] * N + cols[None, :]
            m2 = rm[:, None] & cm[None, :]
            x = tl.load(X + off, mask=m2, other=0.0).to(tl.float32)
            gy = tl.load(GY + off, mask=m2, other=0.0).to(tl.float32)
            mean = tl.load(Mean + r, mask=rm, other=0.0)
            rstd = tl.load(Rstd + r, mask=rm, other=0.0)
            acc_w += gy * ((x - mean[:, None]) * rstd[:, None])
            acc_b += gy
        tl.store(PDW + g * N + cols, tl.sum(acc_w, axis=0), mask=cm)
        tl.store(PDB + g * N + cols, tl.sum(acc_b, axis=0), mask=cm)

    @triton.jit
    def _ln_dwdb_final_kernel(PDW, PDB, DW, DB, G, N,
                              BLOCK_G: tl.constexpr, BLOCK_N: tl.constexpr):
        # stage 2: program c sums the G partials of column block c
        cols = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        cm = cols < N
        acc_w = tl.zeros((BLOCK_G, BLOCK_N), dtype=tl.float32)
        acc_b = tl.zeros((BLOCK_G, BLOCK_N), dtype=tl.float32)
        for g0 in range(0, G, BLOCK_G):
            g = g0 + tl.arange(0, BLOCK_G)
            off = g[:, None] * N + cols[None, :]
            m2 = (g < G)[:, None] & cm[None, :]
            acc_w += tl.load(PDW + off, mask=m2, other=0.0)
            acc_b += tl.load(PDB + off, mask=m2, other=0.0)
        tl.store(DW + cols, tl.sum(acc_w, axis=0).to(DW.dtype.element_ty),
                 mask=cm)
        tl.store(DB + cols, tl.sum(acc_b, axis=0).to(DB.dtype.element_ty),
                 mask=cm)

    _KERNELS = types.SimpleNamespace(
        fwd=_ln_fwd_kernel, add_fwd=_add_ln_fwd_kernel, dx=_ln_dx_kernel,
        dwdb_partial=_ln_dwdb_partial_kernel,
        dwdb_final=_ln_dwdb_final_kernel)
    return _KERNELS


def _block(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _rows_of(x, what: str):
    """x (..., N) as a contiguous (rows, N) view, validated for a kernel."""
    n = x.shape[-1]
    require(x.dtype in _DTYPES,
            f"{what}: layernorm kernels take f32/bf16/f16, got {x.dtype}")
    require(0 < n <= _MAX_N, f"{what}: the kernels hold one row per "
            f"program; N={n} not in [1, {_MAX_N}]")
    return x.reshape(-1, n).contiguous()


def _stats_of(x, mean, rstd, what: str):
    lead = tuple(x.shape[:-1])
    require(tuple(mean.shape) == lead and tuple(rstd.shape) == lead
            and mean.dtype == rstd.dtype == torch.float32,
            f"{what}: mean/rstd must be f32 of shape {lead}, got "
            f"{tuple(mean.shape)} {mean.dtype}, {tuple(rstd.shape)} "
            f"{rstd.dtype}")
    return mean.reshape(-1).contiguous(), rstd.reshape(-1).contiguous()


def _fwd_rows(x, w, b):
    """The forward kernels' checks; x (..., N) as a (rows, N) view with
    unit column stride."""
    n = x.shape[-1]
    require(w.shape == (n,) and b.shape == (n,),
            f"layernorm weight/bias must be ({n},), got {tuple(w.shape)}, "
            f"{tuple(b.shape)}")
    require(x.dtype in _DTYPES,
            f"layernorm kernel takes f32/bf16/f16, got {x.dtype}")
    require(n <= _MAX_N, f"layernorm kernel holds one row per program; "
            f"N={n} > {_MAX_N}")
    x2 = x.reshape(-1, n)
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


def _fwd_outputs(x2):
    """Empty (y, mean, rstd) for the forward of x2's (rows, N)."""
    rows = x2.shape[0]
    return (torch.empty(x2.shape, dtype=x2.dtype, device=x2.device),
            torch.empty((rows,), dtype=torch.float32, device=x2.device),
            torch.empty((rows,), dtype=torch.float32, device=x2.device))


def _fwd_warps(block: int) -> int:
    return 4 if block <= 2048 else 8


def _ln_fwd_triton(x, w, b, eps: float):
    x2 = _fwd_rows(x, w, b)
    rows, n = x2.shape
    y, mean, rstd = _fwd_outputs(x2)
    if rows:
        block = _block(n)
        _triton_kernels().fwd[(rows,)](
            x2, w.contiguous(), b.contiguous(), y, mean, rstd,
            x2.stride(0), y.stride(0), n, eps,
            BLOCK_N=block, num_warps=_fwd_warps(block))
        layernorm_fwd.launches += 1
    lead = x.shape[:-1]
    return y.reshape(x.shape), mean.reshape(lead), rstd.reshape(lead)


def _add_ln_fwd_triton(x, r, w, b, eps: float):
    require(r.shape == x.shape and r.dtype == x.dtype,
            f"add_layernorm: r {tuple(r.shape)} {r.dtype} must "
            f"match x {tuple(x.shape)} {x.dtype}")
    x2 = _fwd_rows(x, w, b).contiguous()
    r2 = r.reshape(x2.shape).contiguous()
    rows, n = x2.shape
    s = torch.empty(x2.shape, dtype=x2.dtype, device=x2.device)
    y, mean, rstd = _fwd_outputs(x2)
    if rows:
        block = _block(n)
        _triton_kernels().add_fwd[(rows,)](
            x2, r2, w.contiguous(), b.contiguous(), s, y, mean, rstd, n,
            eps, BLOCK_N=block, num_warps=_fwd_warps(block))
        add_layernorm_fwd.launches += 1
    lead = x.shape[:-1]
    return (s.reshape(x.shape), y.reshape(x.shape), mean.reshape(lead),
            rstd.reshape(lead))


def _ln_dx_triton(gy, x, w, mean, rstd):
    n = x.shape[-1]
    require(gy.shape == x.shape and w.shape == (n,),
            f"ln_dx: gy {tuple(gy.shape)} / w {tuple(w.shape)} do not "
            f"match x {tuple(x.shape)}")
    x2, gy2 = _rows_of(x, "ln_dx"), _rows_of(gy, "ln_dx")
    require(w.dtype in _DTYPES, f"ln_dx: weight dtype {w.dtype}")
    mean1, rstd1 = _stats_of(x, mean, rstd, "ln_dx")
    rows = x2.shape[0]
    dx = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows:
        block = _block(n)
        _triton_kernels().dx[(rows,)](
            gy2, x2, w.contiguous(), mean1, rstd1, dx, n,
            BLOCK_N=block, num_warps=4 if block <= 2048 else 8)
        layernorm_dx.launches += 1
    return dx.reshape(x.shape)


# stage-1 tile: BLOCK_R rows x BLOCK_N columns per loop step, rows_per rows
# per program; stage 2 folds BLOCK_G partial rows per loop step
_DWDB_BLOCK_R, _DWDB_BLOCK_N, _DWDB_ROWS, _DWDB_BLOCK_G = 16, 128, 64, 32


def _ln_dwdb_triton(gy, x, mean, rstd):
    n = x.shape[-1]
    require(gy.shape == x.shape, f"ln_dwdb: gy {tuple(gy.shape)} does not "
            f"match x {tuple(x.shape)}")
    x2, gy2 = _rows_of(x, "ln_dwdb"), _rows_of(gy, "ln_dwdb")
    mean1, rstd1 = _stats_of(x, mean, rstd, "ln_dwdb")
    rows = x2.shape[0]
    dw = torch.empty((n,), dtype=x.dtype, device=x.device)
    db = torch.empty((n,), dtype=x.dtype, device=x.device)
    k = _triton_kernels()
    g = max(1, -(-rows // _DWDB_ROWS))
    pdw = torch.empty((g, n), dtype=torch.float32, device=x.device)
    pdb = torch.empty((g, n), dtype=torch.float32, device=x.device)
    k.dwdb_partial[(g, -(-n // _DWDB_BLOCK_N))](
        gy2, x2, mean1, rstd1, pdw, pdb, rows, n, _DWDB_ROWS,
        BLOCK_R=_DWDB_BLOCK_R, BLOCK_N=_DWDB_BLOCK_N, num_warps=4)
    k.dwdb_final[(-(-n // 64),)](
        pdw, pdb, dw, db, g, n, BLOCK_G=_DWDB_BLOCK_G, BLOCK_N=64,
        num_warps=4)
    layernorm_dwdb.launches += 1
    return dw, db


# rows a CTA of csrc/ln_bwd.cu owns (its kRows): G = ceil(rows / 64)
_BWD_ROWS = 64
_BWD_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 3
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _rows_ptr(t, n):
    """t (..., N) as rows of N with unit column stride: (the tensor to
    keep alive through the call, its data pointer, its row stride).  A
    contiguous t is passed as it is (no view: each costs the host)."""
    if t.is_contiguous():
        return t, t.data_ptr(), n
    t2 = t.reshape(-1, n)
    if t2.stride(-1) != 1:
        t2 = t2.contiguous()
    return t2, t2.data_ptr(), t2.stride(0)


def _flat_ptr(t):
    return (t if t.is_contiguous() else t.contiguous()).data_ptr()


def _ln_bwd_cuda(gy, x, w, mean, rstd, gs=None, w_dtype=None,
                 b_dtype=None):
    """One `ln_bwd` call of csrc/ln_bwd.cu: both stages, on the current
    stream.  Every operand is checked before anything is built; each
    message is formatted only when its check fails."""
    n = x.shape[-1]
    w_dtype = w.dtype if w_dtype is None else w_dtype
    b_dtype = w_dtype if b_dtype is None else b_dtype
    require(x.dtype in _DTYPES and gy.dtype == x.dtype,
            lambda: f"layernorm_bwd: x and gy must share one of "
            f"f32/bf16/f16, got {x.dtype}, {gy.dtype}")
    require(gy.shape == x.shape, lambda: f"layernorm_bwd: gy "
            f"{tuple(gy.shape)} does not match x {tuple(x.shape)}")
    require(0 < n <= _MAX_N, lambda: f"layernorm_bwd: N={n} not in "
            f"[1, {_MAX_N}]")
    require(w.shape == (n,) and w.dtype in _DTYPES,
            lambda: f"layernorm_bwd: weight must be ({n},) in "
            f"f32/bf16/f16, got {tuple(w.shape)} {w.dtype}")
    lead = x.shape[:-1]
    require(mean.shape == lead and rstd.shape == lead
            and mean.dtype == torch.float32 and rstd.dtype == torch.float32,
            lambda: f"layernorm_bwd: mean/rstd must be f32 of shape "
            f"{tuple(lead)}, got {tuple(mean.shape)} {mean.dtype}, "
            f"{tuple(rstd.shape)} {rstd.dtype}")
    require(gs is None or (gs.shape == x.shape and gs.dtype == x.dtype),
            lambda: f"layernorm_bwd: gs {tuple(gs.shape)} {gs.dtype} must "
            f"match x {tuple(x.shape)} {x.dtype}")
    require(w_dtype in _DTYPES and b_dtype in _DTYPES,
            lambda: f"layernorm_bwd: dw/db dtypes must be f32/bf16/f16, "
            f"got {w_dtype}, {b_dtype}")
    dev = x.device
    require(dev.type == "cuda" and gy.device == dev and w.device == dev
            and mean.device == dev and rstd.device == dev
            and (gs is None or gs.device == dev),
            lambda: "layernorm_bwd: the operands must lie on one CUDA "
            "device")
    x2, px, sx = _rows_ptr(x, n)
    gy2, pgy, sgy = _rows_ptr(gy, n)
    gs2, pgs, sgs = (None, None, 0) if gs is None else _rows_ptr(gs, n)
    rows = x.numel() // n
    groups = -(-rows // _BWD_ROWS)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    part = torch.empty((2 * groups * n,), dtype=torch.float32, device=dev)
    dw = torch.empty((n,), dtype=w_dtype, device=dev)
    db = torch.empty((n,), dtype=b_dtype, device=dev)
    p = part.data_ptr()
    codes = _build.DTYPE_CODES
    err = _build.entry("ln_bwd", "ln_bwd", _BWD_ARGS)(
        pgy, px, pgs, _flat_ptr(w), _flat_ptr(mean), _flat_ptr(rstd),
        dx.data_ptr(), p, p + groups * n * 4, dw.data_ptr(), db.data_ptr(),
        sgy, sx, sgs, rows, n, groups, codes[x.dtype], codes[w.dtype],
        codes[w_dtype], codes[b_dtype], _build.stream_ptr(x))
    _build.check(err, "ln_bwd")
    layernorm_bwd.launches += 1
    if gs is not None:
        layernorm_bwd.launches_gs += 1
    return dx, dw, db


# -- public wrappers --------------------------------------------------------

def layernorm_fwd(x, w, b, eps: float = 1e-5):
    """Returns (y, mean, rstd); mean/rstd are f32 with shape x.shape[:-1].

    CUDA tensors launch the Triton kernel (or raise); CPU tensors take
    `_ln_fwd_plain`."""
    if on_cuda(x, w, b):
        return _ln_fwd_triton(x, w, b, eps)
    return _ln_fwd_plain(x, w, b, eps)


def add_layernorm_fwd(x, r, w, b, eps: float = 1e-5):
    """s = x + r (rounded to x's dtype) and its (y, mean, rstd), as
    `layernorm_fwd(x + r, ...)` gives them.  CUDA tensors launch the
    fused Triton kernel (or raise); CPU tensors take `_add_ln_fwd_plain`."""
    if on_cuda(x, r, w, b):
        return _add_ln_fwd_triton(x, r, w, b, eps)
    return _add_ln_fwd_plain(x, r, w, b, eps)


def layernorm_dx(gy, x, w, mean, rstd):
    """dx for y = xhat*w + b from the saved row stats, in x's dtype.
    CUDA tensors launch the Triton kernel (or raise); CPU tensors take
    `_ln_dx_plain`."""
    if on_cuda(gy, x, w, mean, rstd):
        return _ln_dx_triton(gy, x, w, mean, rstd)
    return _ln_dx_plain(gy, x, w, mean, rstd)


def layernorm_dwdb(gy, x, mean, rstd):
    """(dw, db) summed over every leading dim, in x's dtype.  CUDA
    tensors launch the two-stage Triton reduction (or raise); CPU tensors
    take `_ln_dwdb_plain`."""
    if on_cuda(gy, x, mean, rstd):
        return _ln_dwdb_triton(gy, x, mean, rstd)
    return _ln_dwdb_plain(gy, x, mean, rstd)


def layernorm_bwd(gy, x, w, mean, rstd, gs=None, w_dtype=None,
                  b_dtype=None):
    """LayerNorm's whole backward from the saved row stats: (dx, dw, db),
    dx in x's dtype (plus `gs`, the upstream gradient of the norm's input,
    when given), dw in w_dtype (default w's), db in b_dtype (default
    w_dtype).  CUDA tensors launch csrc/ln_bwd.cu (or raise); CPU tensors
    take `_ln_bwd_plain`."""
    if on_cuda(gy, x, w, mean, rstd, gs):
        return _ln_bwd_cuda(gy, x, w, mean, rstd, gs, w_dtype, b_dtype)
    return _ln_bwd_plain(gy, x, w, mean, rstd, gs, w_dtype, b_dtype)


# kernel launches (CUDA path only); layernorm_bwd.launches_gs counts the
# launches among layernorm_bwd's that added a `gs`
layernorm_fwd.launches = 0
add_layernorm_fwd.launches = 0
layernorm_dx.launches = 0
layernorm_dwdb.launches = 0
layernorm_bwd.launches = 0
layernorm_bwd.launches_gs = 0


class LayerNormFn(torch.autograd.Function):
    """y = layernorm(x) * w + b with the JAX package's vjp rules
    (`_layernorm_fwd_rule` / `_layernorm_bwd_rule`, ops/layernorm.py:153-
    164): the forward saves (x, w, mean, rstd); the backward, one
    `layernorm_bwd` call, returns dx in x's dtype and dw, db through x's
    dtype into the weights' dtypes."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, mean, rstd = layernorm_fwd(x, w, b, eps)
        ctx.save_for_backward(x, w, mean, rstd)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, mean, rstd = ctx.saved_tensors
        dx, dw, db = layernorm_bwd(gy, x, w, mean, rstd, None, w.dtype,
                                   ctx.b_dtype)
        return dx, dw, db, None


def layernorm(x, w, b, eps: float = 1e-5):
    """y only — the call the model makes, differentiable through
    `LayerNormFn`."""
    return LayerNormFn.apply(x, w, b, eps)


class AddLayerNormFn(torch.autograd.Function):
    """(s, y) = (x + r, layernorm(x + r) * w + b) in one forward launch.
    Saves what `LayerNormFn` saves for its input s — (s, w, mean, rstd),
    no more.  The backward is the composition's: s's gradient is the
    upstream g_s plus the norm's dx (autograd's accumulation, in the
    compute dtype; `layernorm_bwd` adds it in the same pass), and it
    flows unchanged to both x and r; dw, db as `LayerNormFn` returns
    them."""

    @staticmethod
    def forward(ctx, x, r, w, b, eps):
        s, y, mean, rstd = add_layernorm_fwd(x, r, w, b, eps)
        ctx.save_for_backward(s, w, mean, rstd)
        ctx.b_dtype = b.dtype
        return s, y

    @staticmethod
    def backward(ctx, gs, gy):
        s, w, mean, rstd = ctx.saved_tensors
        d, dw, db = layernorm_bwd(gy, s, w, mean, rstd, gs, w.dtype,
                                  ctx.b_dtype)
        return d, d, dw, db, None


def add_layernorm(x, r, w, b, eps: float = 1e-5):
    """(x + r, layernorm(x + r)) — the residual add and the next pre-LN
    norm in one call, differentiable through `AddLayerNormFn`."""
    return AddLayerNormFn.apply(x, r, w, b, eps)
