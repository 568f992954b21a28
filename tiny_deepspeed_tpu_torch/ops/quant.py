# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Blockwise absmax quantizer: a hand-written Triton kernel on the card.

Counterpart of `tiny_deepspeed_tpu/parallel/comm.py::quantize_blockwise`
/ `dequantize_blockwise` (:88-129), and the replacement of the TPU kernel
`tiny_deepspeed_tpu/ops/quant_pallas.py::pallas_quantize_blockwise`
(:59, `pallas_call` :71, kernel `_quant_kernel` :42-56).  The port keeps
its own copy of the codec: it imports nothing from `parallel/comm.py`.

Contract (the JAX one): a flat input whose length is a multiple of
`block` -> (codes of the same length, (nb, 1) f32 scales) with, per
block, s = max|x| / qmax + 1e-12 and y = x / s (+ dither); int8 codes
are clip(round_half_even(y), -127, 127), fp8 codes the e4m3fn cast of y
(round to nearest even).  `dither` is an operand (flat uniform(-1/2,
1/2) f32 of x's length, drawn by the caller) as in JAX; the KV pool
passes none, the int8 grad-comm codec (parallel/comm.py) passes one.
On the card every quantize of the grad-comm codecs launches this
kernel: two a gradient sync (the error-fed reduce-scatter payload and
the all-gather's re-quantize), one a step for hpZ's rebuild.

Bound: one read of x (bf16 or f32) and the dither, one write of the
1-byte codes and a 4-byte scale per block, with ~5 operations an
element — far below the card's ~300 flop/byte balance point, so bound by
those bytes.  Design: one program per panel of `_PANEL` elements (whole
blocks, each row a power of two wide with the tail masked):
the row-wise absmax, the divide, the dither, the rounding and the cast
happen in registers, so no f32 copy of the input and no (nb, block)
intermediate ever reaches device memory.  The kernel reads bf16 or f32
and converts to f32 inside (JAX converts first; the values are the
same).  It is bit-identical to the plain version: IEEE division
(`div_rn`; Triton's `/` is approximate), round-half-even (`rint`), the
fp8 cast with round-to-nearest-even, and no FMA contraction.

Dequantization is one multiply per element; it stays plain PyTorch, as
the JAX package leaves it to XLA (the paged-attention kernels dequantize
the KV pool in registers instead).

This module must import without triton: `triton` is imported, and the
kernel defined, inside the function that first launches it.
"""

import torch

from .dispatch import on_cuda, require

QMAX = {"int8": 127.0, "fp8": 448.0}  # e4m3 max normal = 448
QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_EPS = 1e-12
_PANEL = 4096  # elements a program quantizes (whole blocks)


def _check_mode(mode):
    if mode not in QMAX:
        raise ValueError(f"quantize_blockwise mode must be int8/fp8, got "
                         f"{mode!r}")


def _quantize_plain(x, mode: str, block: int, dither=None):
    """The JAX XLA path (comm.py:113-123), op for op in f32.  The divisor
    is a tensor, never a Python scalar: PyTorch's CUDA division by a
    scalar multiplies by its reciprocal, which rounds otherwise."""
    nb = x.numel() // block
    xb = x.reshape(nb, block).float()
    amax = xb.abs().amax(dim=1, keepdim=True)
    s = amax / torch.full_like(amax, QMAX[mode]) + _EPS
    y = xb / s
    if dither is not None:
        y = y + dither.reshape(nb, block).float()
    if mode == "int8":
        q = torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    else:
        q = y.to(torch.float8_e4m3fn)
    return q.reshape(-1), s


_KERNEL = None


def _triton_kernel():
    """Define (once) and return the @triton.jit kernel."""
    global _KERNEL, tl, libdevice
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _quant_kernel(X, D, Q, S, nb, block, qmax, eps,
                      HAS_DITHER: tl.constexpr, INT8: tl.constexpr,
                      ROWS: tl.constexpr, BP2: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BP2)
        rmask = rows < nb
        mask = rmask[:, None] & (cols[None, :] < block)
        offs = rows[:, None] * block + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        amax = tl.max(tl.abs(x), axis=1)
        s = tl.math.div_rn(amax, qmax) + eps
        y = tl.math.div_rn(x, s[:, None])
        if HAS_DITHER:
            y = y + tl.load(D + offs, mask=mask, other=0.0)
        if INT8:
            r = tl.minimum(tl.maximum(libdevice.rint(y), -127.0), 127.0)
            q = r.to(tl.int8)
        else:
            q = y.to(tl.float8e4nv, fp_downcast_rounding="rtne")
        tl.store(Q + offs, q, mask=mask)
        tl.store(S + rows, s, mask=rmask)

    _KERNEL = _quant_kernel
    return _KERNEL


def _quantize_triton(x, mode: str, block: int, dither=None):
    require(x.dtype in (torch.float32, torch.bfloat16, torch.float16),
            f"quantize_blockwise: input dtype {x.dtype} (f32, bf16 or f16)")
    require(1 <= block <= _PANEL, f"quantize_blockwise: block {block} not "
            f"in [1, {_PANEL}]")
    require(x.numel() % block == 0, f"quantize_blockwise: length "
            f"{x.numel()} is not a multiple of block {block}")
    if dither is not None:
        require(dither.dtype == torch.float32
                and dither.numel() == x.numel(),
                "quantize_blockwise: dither must be f32 of x's length")
        dither = dither.reshape(-1).contiguous()
    x = x.reshape(-1).contiguous()
    nb = x.numel() // block
    q = torch.empty(x.numel(), dtype=QDTYPE[mode], device=x.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    if nb == 0:
        return q, s
    bp2 = 1 << (block - 1).bit_length()
    rows = max(1, _PANEL // bp2)
    _triton_kernel()[(-(-nb // rows),)](
        x, x if dither is None else dither, q, s, nb, block, QMAX[mode],
        _EPS, HAS_DITHER=dither is not None, INT8=mode == "int8",
        ROWS=rows, BP2=bp2, num_warps=4, enable_fp_fusion=False)
    quantize_blockwise.launches += 1
    return q, s


def quantize_blockwise(x, mode: str, block: int = 256, dither=None):
    """Flat x (len % block == 0) -> (codes, (nb, 1) f32 scales).  CUDA
    tensors launch the Triton kernel (or raise); CPU tensors take the
    plain version."""
    _check_mode(mode)
    if on_cuda(x, dither):
        return _quantize_triton(x, mode, block, dither)
    return _quantize_plain(x.reshape(-1), mode, block, dither)


quantize_blockwise.launches = 0  # kernel launches (CUDA path only)


def dequantize_blockwise(q, scale):
    """(codes, (nb, 1) scale) -> flat f32 (comm.py:126-129)."""
    nb = scale.shape[0]
    return (q.float().reshape(nb, -1) * scale).reshape(-1)
