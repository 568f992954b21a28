# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Softmax cross-entropy with integer targets, computed in float32.

Counterpart of `tiny_deepspeed_tpu/ops/softmax_xent.py`:

- `softmax_cross_entropy` (:20-27): a numerically stable logsumexp minus
  the gold logit, mean-reduced over all positions; autograd
  differentiates it, as XLA does;
- `fused_linear_xent` (:51-209): the chunked lm_head + loss, which never
  holds the full (B, T, V) logits.  Plain PyTorch, as in JAX, where it is
  an XLA scan with a `custom_vjp` and no Pallas kernel: forward and
  backward stream (B, chunk, V) f32 slabs, the backward recomputing them.

The JAX entry picks its chunk through the runtime autotuner; the port has
no autotuner yet, so the chunk is the tuner-less default (128, JAX's
`cands[0]`, :203-209).  JAX's fp8 head arm (`_head_logits`, :71-80,
env-gated off) waits for the port of `ops/matmul_fp8.py`.
"""

from __future__ import annotations

import warnings

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL.  logits (..., V) any float dtype; targets (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None]).squeeze(-1)
    return (logz - gold).mean()


def _pick_chunk(t: int, want: int) -> int:
    """Largest chunk <= want that divides t; t itself when the only such
    divisor would be below 32 rows (JAX :51-68), with its warning: the
    full-size chunk materializes the whole (B, T, V) logits."""
    for c in range(min(want, t), 31, -1):
        if t % c == 0:
            return c
    if t > want:
        warnings.warn(
            f"fused_linear_xent: sequence length {t} has no chunk divisor in "
            f"[32, {want}]; materializing full (B, {t}, V) logits — pad T "
            "to a multiple of a power of two to keep the chunked path",
            stacklevel=4)
    return t


def _chunk_logits(xc, wf):
    """One chunk's lm_head product with f32 results (JAX's einsum with
    preferred_element_type=f32: f32 products of the operands, f32 sums);
    wf is w in f32."""
    return torch.matmul(xc.float(), wf)


class _ChunkedXentFn(torch.autograd.Function):
    """JAX `_make_flx_variant` (:105-161): forward saves (x, w, targets,
    logz); backward recomputes each chunk's logits, dz = (softmax -
    onehot) * g/(B T) in f32, cast to x's dtype before the two products
    (:142), dx per chunk in x's dtype, dW summed in f32, then cast to w's
    dtype."""

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        b, t, _ = x.shape
        logz = torch.empty((b, t), dtype=torch.float32, device=x.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        wf = w.float()
        for c0 in range(0, t, chunk):
            logits = _chunk_logits(x[:, c0:c0 + chunk], wf)
            lz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(
                -1, targets[:, c0:c0 + chunk].long()[..., None]).squeeze(-1)
            loss_sum = loss_sum + (lz - gold).sum()
            logz[:, c0:c0 + chunk] = lz
        ctx.save_for_backward(x, w, targets, logz)
        ctx.chunk = chunk
        return loss_sum / (b * t)

    @staticmethod
    def backward(ctx, g):
        x, w, targets, logz = ctx.saved_tensors
        b, t, _ = x.shape
        chunk = ctx.chunk
        scale = g.float() / (b * t)
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
        wf = w.float()
        for c0 in range(0, t, chunk):
            xc = x[:, c0:c0 + chunk]
            logits = _chunk_logits(xc, wf)
            p = torch.exp(logits - logz[:, c0:c0 + chunk, None])
            tc = targets[:, c0:c0 + chunk].long()[..., None]
            p = p.scatter_add(-1, tc, torch.full_like(tc, -1.0,
                                                      dtype=p.dtype))
            # grads flow at compute precision
            pc = (p * scale).to(x.dtype).float()
            dx[:, c0:c0 + chunk] = torch.matmul(pc, wf.t()).to(x.dtype)
            dw += torch.einsum("btd,btv->dv", xc.float(), pc)
        return dx, dw.to(w.dtype), None, None


def fused_linear_xent(x, w, targets, chunk: int = 128):
    """Mean NLL of logits = x @ w without materializing the (B, T, V)
    logits.  x (B, T, D); w (D, V); targets (B, T) int."""
    return _ChunkedXentFn.apply(x, w, targets, _pick_chunk(x.shape[1], chunk))
