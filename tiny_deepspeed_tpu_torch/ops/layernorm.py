# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""LayerNorm forward (y, mean, rstd): hand-written Triton kernel on the card.

Replaces the TPU kernel `tiny_deepspeed_tpu/ops/layernorm_pallas.py::
ln_fwd_pallas` (the `pallas_call` at :87; dispatched from
`ops/layernorm.py:36-58`).  The Pallas kernel tiles rows into VMEM blocks
that must divide the row count (:41-58, with an XLA fallback); on Hopper
that tiling buys nothing.  One program normalizes one row: N (768 on
gpt2-124m) fits one power-of-two block, so x is read once and y written
once — the op is bound by those bytes (a few flops per element against
the card's ~300 flop/byte balance point), and the kernel moves nothing
else but the 8-byte (mean, rstd) per row.  Any row count works; no
divisibility fallback exists.

Numerics follow `_ln_fwd_xla` (ops/layernorm.py:71-78): statistics in f32
with var = E[x^2] - mean^2, output cast back to x's dtype.  The backward
(dx, dwdb kernels) waits for the training slice.

This module must import without triton: `triton` is imported, and the
kernel defined, inside the function that first launches it.  It also
avoids `from __future__ import annotations`, so the kernel's
`tl.constexpr` annotation is a real object when Triton reads it.
"""

import torch

from .dispatch import on_cuda, require


def _ln_fwd_plain(x, w, b, eps: float = 1e-5):
    """The plain PyTorch version (the CPU path and the card reference)."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean[..., None]) * rstd[..., None]
    y = y * w.float() + b.float()
    return y.to(x.dtype), mean, rstd


_KERNEL = None


def _triton_kernel():
    """Define (once) and return the @triton.jit forward kernel."""
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
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

    _KERNEL = _ln_fwd_kernel
    return _KERNEL


def _ln_fwd_triton(x, w, b, eps: float):
    n = x.shape[-1]
    require(w.shape == (n,) and b.shape == (n,),
            f"layernorm weight/bias must be ({n},), got {tuple(w.shape)}, "
            f"{tuple(b.shape)}")
    require(x.dtype in (torch.float32, torch.bfloat16, torch.float16),
            f"layernorm kernel takes f32/bf16/f16, got {x.dtype}")
    require(n <= 16384, f"layernorm kernel holds one row per program; "
            f"N={n} > 16384")
    x2 = x.reshape(-1, n)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    mean = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        block = 1 << (n - 1).bit_length()
        _triton_kernel()[(rows,)](
            x2, w.contiguous(), b.contiguous(), y, mean, rstd,
            x2.stride(0), y.stride(0), n, eps,
            BLOCK_N=block, num_warps=4 if block <= 2048 else 8)
        layernorm_fwd.launches += 1
    lead = x.shape[:-1]
    return y.reshape(x.shape), mean.reshape(lead), rstd.reshape(lead)


def layernorm_fwd(x, w, b, eps: float = 1e-5):
    """Returns (y, mean, rstd); mean/rstd are f32 with shape x.shape[:-1].

    CUDA tensors launch the Triton kernel (or raise); CPU tensors take
    `_ln_fwd_plain`."""
    if on_cuda(x, w, b):
        return _ln_fwd_triton(x, w, b, eps)
    return _ln_fwd_plain(x, w, b, eps)


layernorm_fwd.launches = 0  # kernel launches (CUDA path only)


def layernorm(x, w, b, eps: float = 1e-5):
    """y only — the call the model makes."""
    return layernorm_fwd(x, w, b, eps)[0]
