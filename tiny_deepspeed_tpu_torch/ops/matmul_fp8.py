# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""fp8 (e4m3) matmuls for the block products and the chunked head.

Counterpart of `tiny_deepspeed_tpu/ops/matmul_fp8.py`, all of it: the
modes (`set_fp8_matmul`, `fp8_matmul_mode`, `fp8_matmul_forced`),
`_quantize`, `fp8_matmul` (just-in-time scaling: per-row scales on x,
per-column scales on w, an f32 accumulator and the rank-1 rescale
`y * sx * sw`), the `linear` candidate `_fwd_fp8`, and delayed scaling
(`Fp8History`, `fp8_history`, `_delayed_amax`, `fp8_matmul_delayed`),
functional as in JAX: it returns the rolled history.

Modes: "off" (default) — `linear` and the chunked head run exactly the
ops they ran before this module existed; "candidate" — `_fwd_fp8` joins
`linear_forward`'s autotuner candidates and wins only if timed faster;
"on" — every `linear` and the chunked head's logits run fp8.  The fused
CUDA head (ops/fused_xent.py) does not consult the mode, as JAX's
Pallas head does not.

The quantization is plain PyTorch ops, as it is XLA ops in JAX: scale =
amax / 448 + 1e-12 (no gradient), clip to +-448, cast to e4m3 — the same
codes as JAX's cast, bit for bit.  The product:

- on the CPU the codes are upcast to f32 for an f32 matmul, as JAX does
  off-TPU (`_dot_dtype`, :90-95): the same numbers, the rounding to
  e4m3 already happened;
- on the card it runs on Hopper's fp8 tensor cores through
  `torch._scaled_mm`, x flattened to 2-D (row-major) and w handed
  column-major.  `_scaled_mm` takes row-wise scales only with a bf16
  output, so it gets unit scales and an f32 output, and JAX's own
  rank-1 rescale follows on the f32 result: the literal counterpart of
  :117-122.  `use_fast_accum=False`: cuBLAS promotes Hopper's narrower
  fp8 accumulator into f32 at intervals.  It needs K and N multiples of
  16 (and refuses other shapes on its own); a shape it refuses RAISES —
  under the autotuner that scores `inf` and is counted, in mode "on" it
  is an error.  There is no fallback to a bf16 product.

`fp8_matmul` itself has no gradient (`_scaled_mm` has none): the
`linear` candidate `_fwd_fp8` is `Fp8LinearFn`, whose backward is JAX's
closed form on the unquantized operands (`_linear_bwd_rule`,
ops/linear.py:140-151), and the chunked head differentiates its logits
in closed form too.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch

from .dispatch import require, resolve_device

E4M3_MAX = 448.0
_EPS = 1e-12

FP8_MATMUL_MODES = ("off", "candidate", "on")
_MODE = "off"


def set_fp8_matmul(mode: str) -> None:
    if mode not in FP8_MATMUL_MODES:
        raise ValueError(
            f"fp8_matmul must be one of {FP8_MATMUL_MODES}, got {mode!r}")
    global _MODE
    _MODE = mode


def fp8_matmul_mode() -> str:
    return _MODE


@contextmanager
def fp8_matmul_forced(mode: str):
    prev = _MODE
    set_fp8_matmul(mode)
    try:
        yield
    finally:
        set_fp8_matmul(prev)


def _quantize(x, amax):
    """Scale x into e4m3 range against `amax` (no gradient), clip, cast:
    (e4m3 codes, f32 scale).  The clip bounds values that outran a stale
    (delayed) amax."""
    scale = (amax.float() / E4M3_MAX + _EPS).detach()
    q = torch.clamp(x.float() / scale, -E4M3_MAX, E4M3_MAX)
    return q.to(torch.float8_e4m3fn), scale


_UNIT = {}  # device -> the f32 unit scale _scaled_mm takes


def _dot_f32(qx, qw):
    """(..., K) codes @ (K, N) codes -> (..., N) f32: the fp8 tensor
    cores on the card, an f32 matmul of the upcast codes on the CPU."""
    if not qx.is_cuda:
        return torch.matmul(qx.float(), qw.float())
    k, n = qw.shape
    require(k % 16 == 0 and n % 16 == 0,
            lambda: f"fp8_matmul: torch._scaled_mm needs K and N multiples "
            f"of 16, got K={k} N={n}")
    one = _UNIT.get(qx.device)
    if one is None:
        one = _UNIT[qx.device] = torch.ones((), dtype=torch.float32,
                                            device=qx.device)
    y = torch._scaled_mm(qx.reshape(-1, k), qw.t().contiguous().t(),
                         scale_a=one, scale_b=one, out_dtype=torch.float32,
                         use_fast_accum=False)
    return y.reshape(*qx.shape[:-1], n)


def _quantize_cols(w):
    """w (K, N) quantized with a scale per column: (codes, (1, N))."""
    return _quantize(w, w.abs().amax(dim=0, keepdim=True))


def fp8_matmul_q(x, qw, sw):
    """`fp8_matmul` with w already quantized (`_quantize_cols`): the
    chunked head quantizes its weight once per pass, each chunk the same
    codes JAX's per-chunk call makes."""
    qx, sx = _quantize(x, x.abs().amax(dim=-1, keepdim=True))
    return _dot_f32(qx, qw) * sx * sw  # rank-1 rescale on the f32 result


def fp8_matmul(x, w):
    """y[..., n] = x[..., k] @ w[k, n] with both operands quantized to
    e4m3: per-row (leading-position) scales on x, per-column scales on
    w.  f32 accumulation and output (callers cast).  No gradient."""
    return fp8_matmul_q(x, *_quantize_cols(w))


class Fp8LinearFn(torch.autograd.Function):
    """y = fp8_matmul(x, w) in x's dtype (+ b in y's dtype); the backward
    is JAX's exact closed form on the unquantized operands
    (`_linear_bwd_rule`, ops/linear.py:140-151): dx = gy w^T in gy's
    dtype, dw = x^T gy (leading dims contracted) in x's dtype then w's,
    db = sum gy in f32, then gy's dtype, then b's."""

    @staticmethod
    def forward(ctx, x, w, b):
        y = fp8_matmul(x, w).to(x.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        ctx.save_for_backward(x, w)
        ctx.b_dtype = None if b is None else b.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        k, n = w.shape
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gy, w.to(gy.dtype).t())
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.reshape(-1, k).t(),
                              gy.reshape(-1, n).to(x.dtype)).to(w.dtype)
        if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
            db = (gy.float().sum(dim=tuple(range(gy.dim() - 1)))
                  .to(gy.dtype).to(ctx.b_dtype))
        return dx, dw, db


def _fwd_fp8(x, w, b):
    """`linear_forward` candidate: the fp8 forward product, bias in the
    output dtype; differentiable through `Fp8LinearFn`."""
    return Fp8LinearFn.apply(x, w, b)


# ---------------------------------------------------------------------------
# delayed scaling
# ---------------------------------------------------------------------------


class Fp8History(NamedTuple):
    """Rolling per-tensor amax histories of one matmul site: the
    delayed-scaling state a training loop threads through its step.
    Row 0 is the most recent step."""

    x_amax: torch.Tensor  # (H,) f32
    w_amax: torch.Tensor  # (H,) f32


def fp8_history(length: int = 16, device=None) -> Fp8History:
    dev = resolve_device(device)
    return Fp8History(torch.zeros(length, dtype=torch.float32, device=dev),
                      torch.zeros(length, dtype=torch.float32, device=dev))


def _delayed_amax(hist, cur):
    """max over the recorded history; a cold (all-zero) history falls
    back to the current amax, so step 0 is just-in-time scaled."""
    h = hist.max()
    return torch.where(h > 0, h, cur)


def _roll_in(hist, cur):
    """jnp.roll(hist, 1).at[0].set(cur)."""
    return torch.cat([cur.reshape(1), hist[:-1]])


def fp8_matmul_delayed(x, w, hist: Fp8History):
    """Delayed-scaling fp8 matmul: quantize against the HISTORY's amax
    (values clipped into range when this step outruns it), then record
    this step's amax.  Returns (y f32, the updated Fp8History)."""
    cx = x.abs().max().float()
    cw = w.abs().max().float()
    qx, sx = _quantize(x, _delayed_amax(hist.x_amax, cx))
    qw, sw = _quantize(w, _delayed_amax(hist.w_amax, cw))
    y = _dot_f32(qx, qw) * sx * sw
    return y, Fp8History(_roll_in(hist.x_amax, cx),
                         _roll_in(hist.w_amax, cw))
