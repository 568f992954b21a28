# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Inverted dropout with counter-based masks: a Triton kernel on the card.

No TPU kernel stands behind it: the JAX package drops with
`jax.random.bernoulli` + `jnp.where` (models/gpt2.py `_dropout`,
:228-234), two XLA ops.  The port adds one kernel because its masks must
not depend on the rank layout, and a mask drawn from a generator over a
rank's local shape does.

The mask.  Element e of a tensor is kept iff u(key, g) < keep, where g
is e's flat index in the GLOBAL tensor the rank holds a block of
(`frame` = (global shape, this block's offsets); default the tensor
itself) and u is the top 24 bits of the splitmix64 stream seeded with
`key` at position g — `rng._mix(key + g * golden)` — times 2**-24, in
f32, compared with keep in f32 (as `torch.rand(...) < keep` compares).
A token's mask is then the same at data 1, 2 or 4, under any seq split
and under the ring or Ulysses.  The bits are the port's own, not JAX's.

`dropout(x, key, rate, frame)` is `DropoutFn`: y = where(mask, x / keep,
0) in f32, cast to x's dtype, and the same on the gradient.  It saves
no mask: the backward recomputes the bits from the key, as a remat
recompute of the forward redraws them.  CUDA tensors launch the kernel
(or raise); CPU tensors take the plain version, whose mask is drawn by
`mask_fn` (default `dropout_keep`: the same hash in int64 torch ops,
with the logical shifts masked out of torch's arithmetic ones and the
products wrapping mod 2**64).  Kernel and plain version agree bit for
bit: the bits are integers, the divide is IEEE (`div_rn`) on both.

Bound: one read of x and one write of y (2 x 2 bytes an element in
bf16), no floating-point work beyond a compare and a divide, so the
stated bound is those bytes.  The hash costs some thirty 32-bit integer
instructions an element (three 64-bit products), which the integer
pipes may not hide behind the bytes; the measured time says which.
Design: a 2-D grid of (ROWS rows of C) x (BLOCK_C columns) tiles; the
global row index is computed per row (one int64 divide a row, none an
element), the column runs contiguous, x is read once and y written
once, and nothing else touches memory.

This module must import without triton: `triton` is imported, and the
kernel defined, inside the function that first launches it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .dispatch import acc_dtype, on_cuda, require

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB

_ROWS = 8
_BLOCK_C = 256

Frame = Optional[Tuple[Sequence[int], Sequence[int]]]


def _signed(v: int) -> int:
    """A 64-bit unsigned value as torch's int64 holds it."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 z (torch's >> is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def frame_of(shape, frame: Frame):
    """(global shape, offsets) of a block of `shape`, padded to the
    block's rank; the whole tensor when frame is None."""
    if frame is None:
        return tuple(shape), (0,) * len(shape)
    gshape, offs = tuple(frame[0]), tuple(frame[1])
    require(len(gshape) == len(shape) == len(offs),
            f"dropout frame {frame} does not fit a block of {tuple(shape)}")
    require(all(0 <= o and o + n <= g
                for o, n, g in zip(offs, shape, gshape)),
            f"dropout block {tuple(shape)} at {offs} leaves {gshape}")
    return gshape, offs


def global_index(shape, frame: Frame, device) -> torch.Tensor:
    """int64 tensor of `shape`: each element's flat index in the global
    tensor of `frame`."""
    gshape, offs = frame_of(shape, frame)
    g = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        ix = torch.arange(shape[d], dtype=torch.int64, device=device)
        ix = (ix + offs[d]) * stride
        g = g + ix.reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= gshape[d]
    return g.expand(tuple(shape))


def dropout_keep(key: int, shape, keep: float, device,
                 frame: Frame = None) -> torch.Tensor:
    """The keep mask (bool, `shape`) of the block at `frame` (default:
    the whole tensor), drawn counter-based from `key`: the plain version
    of the kernel's hash."""
    z = global_index(tuple(shape), frame, device)
    z = (z + 1) * _signed(_GOLDEN) + _signed(key)
    z = (z ^ _srl(z, 30)) * _signed(_MIX1)
    z = (z ^ _srl(z, 27)) * _signed(_MIX2)
    z = z ^ _srl(z, 31)
    u = _srl(z, 40).to(torch.float32) * (1.0 / (1 << 24))
    return u < torch.tensor(keep, dtype=torch.float32, device=device)


def _dropout_plain(x, key: int, keep: float, frame: Frame, mask_fn=None):
    """where(mask, x / keep, 0) in f32 (f64 for f64), cast to x's dtype.
    The divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds otherwise."""
    mask_fn = mask_fn or dropout_keep
    mask = mask_fn(key, tuple(x.shape), keep, x.device, frame)
    acc = acc_dtype(x.dtype)
    kt = torch.tensor(keep, dtype=torch.float32, device=x.device).to(acc)
    return torch.where(mask, x.to(acc) / kt, 0.0).to(x.dtype)


_KERNEL = None


def _triton_kernel():
    """Define (once) and return the @triton.jit kernel."""
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["n_rows", "tl_", "C", "T", "GC", "oa",
                                   "ot", "oc", "key_lo", "key_hi"])
    def _dropout_kernel(X, Y, n_rows, tl_, C, T, GC, oa, ot, oc, key_lo,
                        key_hi, keep, ROWS: tl.constexpr,
                        BLOCK_C: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        cols = tl.program_id(1).to(tl.int64) * BLOCK_C + tl.arange(
            0, BLOCK_C)
        mask = (rows < n_rows)[:, None] & (cols < C)[None, :]
        a = rows // tl_
        grow = (a + oa) * T + (rows - a * tl_) + ot
        g = (grow[:, None] * GC + (cols[None, :] + oc)).to(
            tl.uint64, bitcast=True)
        key = (key_hi.to(tl.uint64) << 32) | key_lo.to(tl.uint64)
        z = (g + 1) * 0x9E3779B97F4A7C15 + key
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB
        z = z ^ (z >> 31)
        u = (z >> 40).to(tl.float32) * (1.0 / 16777216.0)
        offs = rows[:, None] * C + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        y = tl.where(u < keep, tl.math.div_rn(x, keep), 0.0)
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)

    _KERNEL = _dropout_kernel
    return _KERNEL


def _dropout_triton(x, key: int, keep: float, frame: Frame):
    require(x.dtype in (torch.float32, torch.bfloat16, torch.float16),
            lambda: f"dropout: dtype {x.dtype} (f32, bf16 or f16)")
    require(1 <= x.dim() <= 3,
            lambda: f"dropout: {x.dim()}-D input (1 to 3 dims)")
    gshape, offs = frame_of(x.shape, frame)
    pad = 3 - x.dim()
    a, t, c = (1,) * pad + tuple(x.shape)
    _, gt, gc = (1,) * pad + gshape
    oa, ot, oc = (0,) * pad + offs
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    key &= _M64
    grid = (-(-(a * t) // _ROWS), -(-c // _BLOCK_C))
    _triton_kernel()[grid](
        x, y, a * t, t, c, gt, gc, oa, ot, oc, key & 0xFFFFFFFF, key >> 32,
        float(keep), ROWS=_ROWS, BLOCK_C=_BLOCK_C, num_warps=4)
    dropout.launches += 1
    return y


def _apply(x, key: int, keep: float, frame: Frame, mask_fn=None):
    if on_cuda(x):
        return _dropout_triton(x, key, keep, frame)
    return _dropout_plain(x, key, keep, frame, mask_fn)


class DropoutFn(torch.autograd.Function):
    """y = where(mask, x / keep, 0); the gradient the same formula on dy,
    its mask recomputed from the key (nothing saved)."""

    @staticmethod
    def forward(ctx, x, key, keep, frame, mask_fn):
        ctx.args = (key, keep, frame, mask_fn)
        return _apply(x, key, keep, frame, mask_fn)

    @staticmethod
    def backward(ctx, dy):
        return _apply(dy, *ctx.args), None, None, None, None


def dropout(x, key: int, rate: float, frame: Frame = None, mask_fn=None):
    """Inverted dropout of x at `rate` with the counter-based mask of
    `key` over `frame` (see the module docstring).  `mask_fn(key, shape,
    keep, device, frame)` replaces the CPU route's mask draw (the tests
    hand JAX's masks in through it); CUDA tensors always launch the
    kernel."""
    return DropoutFn.apply(x, key, 1.0 - rate, frame, mask_fn)


dropout.launches = 0  # kernel launches (CUDA path only)
