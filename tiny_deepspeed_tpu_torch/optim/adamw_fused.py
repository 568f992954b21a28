# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Fused AdamW update: one hand-written Triton kernel per leaf on the card.

Replaces the TPU kernel `tiny_deepspeed_tpu/optim/adamw_pallas.py::
adamw_update_pallas` (:69, `pallas_call` :108, kernel `_kernel` :49-66):
p, g, m and v stream through once and p, m, v are written once, the
update math done in registers.  The port updates the f32 leaf and its
moments IN PLACE (the JAX kernel returns new arrays).

Bound: purely elementwise, ~15 flops per element against 28 bytes (f32
p, g, m, v read; p, m, v written) — far below the card's ~300 flop/byte
balance point, so bound by those bytes at 3.35 TB/s (gpt2-124m's 38.6M
lm_head leaf: 1.08 GB, 0.323 ms).  Design: one program per 4096-element
block with a masked tail; 16 elements a thread, each array read or
written in 16-byte vectors.  `lr`, `c1 = 1 - b1^t` and `c2 = 1 - b2^t`
are runtime scalars, so an lr schedule runs through the same compiled
kernel; the flags (weight-decay mode, maximize) are compile-time.  The
kernel compiles without FMA contraction, so each product rounds before
its sum as in the plain version (and the JAX kernel): Adam's first step
divides g + wd p by about eps where that sum cancels, and a contracted
FMA there moved updates by up to 1e-4 of a leaf's largest weight.

The JAX wrapper pads each leaf to (rows, 1024) VMEM tiles and keeps
leaves under 8192 elements on the XLA path (`MIN_SIZE`); neither rule
has a reason to exist on Hopper, so every leaf, whatever its size, goes
through the kernel.  This module must import without triton: `triton` is
imported, and the kernel defined, inside the function that first
launches it (and `from __future__ import annotations` is avoided so the
kernel's `tl.constexpr` annotations stay real objects).
"""

import torch

from ..ops.dispatch import on_cuda, require

_BLOCK = 4096


def _adamw_update_plain(p, g, m, v, *, lr, c1, c2, b1, b2, eps, wd,
                        decoupled, maximize):
    """A line-for-line copy of the JAX `_kernel` (:49-66), in place on
    f32 p, m, v."""
    g = g.to(p.dtype)
    if maximize:
        g = -g
    if wd and not decoupled:
        g = g + wd * p  # reference adamw.py:37-38 (L2-into-grad)
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    if wd and decoupled:
        upd = upd + wd * p
    p.copy_(p - lr * upd)
    m.copy_(m_new)
    v.copy_(v_new)


_KERNEL = None


def _triton_kernel():
    """Define (once) and return the @triton.jit kernel."""
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _adamw_kernel(P, G, M, V, n, lr, c1, c2, b1, b2, omb1, omb2, eps,
                      wd, WD_MODE: tl.constexpr, MAXIMIZE: tl.constexpr,
                      BLOCK: tl.constexpr):
        # WD_MODE: 0 no decay, 1 L2-folded into g, 2 decoupled; omb1 /
        # omb2 = 1 - b1 / 1 - b2, taken in double on the host as the JAX
        # kernel's Python floats are (1 - b2 in f32 is off by 1.3e-5)
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        p = tl.load(P + offs, mask=mask, other=0.0)
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        m = tl.load(M + offs, mask=mask, other=0.0)
        v = tl.load(V + offs, mask=mask, other=0.0)
        if MAXIMIZE:
            g = -g
        if WD_MODE == 1:
            g = g + wd * p
        m = b1 * m + omb1 * g
        v = b2 * v + omb2 * g * g
        upd = (m / c1) / (tl.sqrt(v / c2) + eps)
        if WD_MODE == 2:
            upd = upd + wd * p
        tl.store(P + offs, p - lr * upd, mask=mask)
        tl.store(M + offs, m, mask=mask)
        tl.store(V + offs, v, mask=mask)

    _KERNEL = _adamw_kernel
    return _KERNEL


def _adamw_update_triton(p, g, m, v, *, lr, c1, c2, b1, b2, eps, wd,
                         decoupled, maximize):
    require(p.dtype == m.dtype == v.dtype == torch.float32,
            f"adamw_update_fused: p, m, v must be f32, got {p.dtype}, "
            f"{m.dtype}, {v.dtype}")
    require(g.dtype in (torch.float32, torch.bfloat16, torch.float16),
            f"adamw_update_fused: grad dtype {g.dtype}")
    require(p.shape == g.shape == m.shape == v.shape,
            f"adamw_update_fused: shapes {tuple(p.shape)}, "
            f"{tuple(g.shape)}, {tuple(m.shape)}, {tuple(v.shape)} differ")
    require(p.is_contiguous() and m.is_contiguous() and v.is_contiguous(),
            "adamw_update_fused: p, m, v are updated in place and must be "
            "contiguous")
    n = p.numel()
    if n == 0:
        return
    mode = 0 if not wd else (2 if decoupled else 1)
    _triton_kernel()[(-(-n // _BLOCK),)](
        p, g.contiguous(), m, v, n, float(lr), float(c1), float(c2),
        float(b1), float(b2), 1.0 - b1, 1.0 - b2, float(eps), float(wd),
        WD_MODE=mode, MAXIMIZE=bool(maximize), BLOCK=_BLOCK, num_warps=8,
        enable_fp_fusion=False)
    adamw_update_fused.launches += 1


def adamw_update_fused(p, g, m, v, *, lr, c1, c2, b1, b2, eps, wd,
                       decoupled=False, maximize=False):
    """One AdamW step of an f32 leaf, in place on p, m, v: g folded with
    L2 decay (or decoupled decay on the update), m and v advanced, p -=
    lr * (m / c1) / (sqrt(v / c2) + eps), c1 = 1 - b1^t and
    c2 = 1 - b2^t.  CUDA tensors launch the Triton kernel (or raise); CPU
    tensors take `_adamw_update_plain`."""
    kw = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, wd=wd,
              decoupled=decoupled, maximize=maximize)
    if on_cuda(p, g, m, v):
        return _adamw_update_triton(p, g, m, v, **kw)
    return _adamw_update_plain(p, g, m, v, **kw)


# kernel launches (CUDA path only)
adamw_update_fused.launches = 0
