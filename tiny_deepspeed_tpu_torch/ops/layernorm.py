# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""LayerNorm forward and backward: hand-written Triton kernels on the card.

Counterpart of `tiny_deepspeed_tpu/ops/layernorm.py` (the `custom_vjp` at
:147-167) and of its three Pallas kernels in `ops/layernorm_pallas.py`:

- forward `ln_fwd_pallas` (:78, `pallas_call` :87) -> (y, mean, rstd);
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
- dwdb: the TPU grid runs in order and carries the sums with `+=` across
  grid steps (:168-182); Hopper runs blocks in parallel and in no order.
  So it is two kernels, the reference's own decomposition
  (layernorm_pallas.py:16-21): stage 1 reduces a tile of rows x columns
  per program into an f32 (G, N) partials buffer; stage 2 reduces the G
  partials per column.  No float atomics: dw and db are bit-for-bit
  repeatable, run to run.  Bound by reading gy and x once (the partials
  are ~1 MB at gpt2-124m's 8192 x 768, noise beside 25 MB).

Numerics follow the JAX package's XLA versions (`_ln_fwd_xla`,
`_ln_dx_xla`, `_ln_dwdb_xla`, :71-134): statistics in f32 with
var = E[x^2] - mean^2; dx in x's dtype; dw/db emitted in x's dtype, then
cast to the weight's dtype by the backward rule (:158-164).

This module must import without triton: `triton` is imported, and the
kernels defined, inside the function that first launches one.  It also
avoids `from __future__ import annotations`, so the kernels'
`tl.constexpr` annotations are real objects when Triton reads them.
"""

import types

import torch

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
        fwd=_ln_fwd_kernel, dx=_ln_dx_kernel,
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


def _ln_fwd_triton(x, w, b, eps: float):
    n = x.shape[-1]
    require(w.shape == (n,) and b.shape == (n,),
            f"layernorm weight/bias must be ({n},), got {tuple(w.shape)}, "
            f"{tuple(b.shape)}")
    require(x.dtype in _DTYPES,
            f"layernorm kernel takes f32/bf16/f16, got {x.dtype}")
    require(n <= _MAX_N, f"layernorm kernel holds one row per program; "
            f"N={n} > {_MAX_N}")
    x2 = x.reshape(-1, n)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    mean = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        block = _block(n)
        _triton_kernels().fwd[(rows,)](
            x2, w.contiguous(), b.contiguous(), y, mean, rstd,
            x2.stride(0), y.stride(0), n, eps,
            BLOCK_N=block, num_warps=4 if block <= 2048 else 8)
        layernorm_fwd.launches += 1
    lead = x.shape[:-1]
    return y.reshape(x.shape), mean.reshape(lead), rstd.reshape(lead)


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


# -- public wrappers --------------------------------------------------------

def layernorm_fwd(x, w, b, eps: float = 1e-5):
    """Returns (y, mean, rstd); mean/rstd are f32 with shape x.shape[:-1].

    CUDA tensors launch the Triton kernel (or raise); CPU tensors take
    `_ln_fwd_plain`."""
    if on_cuda(x, w, b):
        return _ln_fwd_triton(x, w, b, eps)
    return _ln_fwd_plain(x, w, b, eps)


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


# kernel launches (CUDA path only)
layernorm_fwd.launches = 0
layernorm_dx.launches = 0
layernorm_dwdb.launches = 0


class LayerNormFn(torch.autograd.Function):
    """y = layernorm(x) * w + b with the JAX package's vjp rules
    (`_layernorm_fwd_rule` / `_layernorm_bwd_rule`, ops/layernorm.py:153-
    164): the forward saves (x, w, mean, rstd); the backward returns dx
    in x's dtype and dw, db through x's dtype into the weights' dtypes."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, mean, rstd = layernorm_fwd(x, w, b, eps)
        ctx.save_for_backward(x, w, mean, rstd)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, mean, rstd = ctx.saved_tensors
        dx = layernorm_dx(gy, x, w, mean, rstd)
        dw, db = layernorm_dwdb(gy, x, mean, rstd)
        return dx, dw.to(w.dtype), db.to(ctx.b_dtype), None


def layernorm(x, w, b, eps: float = 1e-5):
    """y only — the call the model makes, differentiable through
    `LayerNormFn`."""
    return LayerNormFn.apply(x, w, b, eps)
