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

The chunk is JAX's autotuner site (:163-209): the module-level variants
`fused_linear_xent_c64`, `_c128` and `_c256` (stable names, JAX's
`_FLX_VARIANTS`), de-duplicated by effective chunk in JAX's order (128,
64, 256), picked per (shape, dtype) by the installed tuner; 128 without
one.  Under `ops/matmul_fp8` mode "on" the chunk logits are
`fp8_matmul` (JAX `_head_logits`, :71-79), in the forward and in the
backward's recompute — the same logits the forward saw; dx and dW stay
at compute precision, as JAX's do.

The vocab-parallel head (tensor parallelism, `vocab=(comm, lo)`): the
rank holds lm_head's columns [lo, lo + V/tp) and the logits of those
columns; the rest of the row lives on the other model ranks, and the
group's communicator (`mesh.GroupReduce`) completes it — each row's max
by an all-reduce MAX, its sum of exponentials and its target logit (the
rank whose range holds the target gives it, the others 0) by one
all-reduce SUM.  The backward is local, softmax - onehot on the rank's
columns; the caller's `ops.collectives.copy_to` sums dx over the group.
Under GSPMD the JAX head computes the same sums over its sharded logits
(XLA, no Pallas kernel), and the f32 loss is the same on every model
rank.  The per-rank pieces are `vp_stats`, `vp_combine` and `vp_grads`;
`parallel.one_process.lockstep` runs a layout's ranks through them in
one process (chip_smoke.py's phase 17, the CPU tests).
"""

from __future__ import annotations

import warnings

import torch

from ..autotuner import runtime_tuner as _rt
from . import matmul_fp8 as _fp8


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          vocab=None) -> torch.Tensor:
    """Mean NLL.  logits (..., V) any float dtype; targets (...) int.
    With `vocab` = (comm, lo), logits are the rank's columns [lo, lo +
    V_local) of the vocab-parallel head (module docstring)."""
    if vocab is not None:
        return _VocabXentFn.apply(logits, targets, vocab[0], vocab[1])
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None]).squeeze(-1)
    return (logz - gold).mean()


def vp_stats(logits: torch.Tensor, targets: torch.Tensor, lo: int):
    """One rank's share of the vocab-parallel loss on its (..., V_local)
    f32 logits: (each row's logsumexp over the rank's columns, the target
    logit where the rank's range [lo, lo + V_local) holds the target,
    else 0)."""
    v = logits.shape[-1]
    t = targets.long() - lo
    mine = (t >= 0) & (t < v)
    gold = logits.gather(-1, torch.where(mine, t, 0)[..., None]).squeeze(-1)
    return torch.logsumexp(logits, dim=-1), torch.where(mine, gold, 0.0)


def vp_combine(lz: torch.Tensor, gold: torch.Tensor, comm):
    """The rows' global logsumexp and target logit from every rank's
    `vp_stats`: the max of the ranks' logsumexps (all-reduce MAX), then
    the sum of exp(lz - max) and of the target logits (one all-reduce
    SUM).  Returns (logz, gold), each f32 like lz."""
    m = comm.all_reduce(lz, "max")
    s = comm.all_reduce(torch.stack([torch.exp(lz - m), gold]), "sum")
    return m + torch.log(s[0]), s[1]


def vp_grads(logits: torch.Tensor, targets: torch.Tensor, lo: int,
             logz: torch.Tensor, scale) -> torch.Tensor:
    """The rank's (..., V_local) f32 dlogits: (softmax - onehot) * scale,
    the onehot where its range holds the target."""
    v = logits.shape[-1]
    p = torch.exp(logits - logz[..., None])
    t = targets.long() - lo
    mine = (t >= 0) & (t < v)
    p = p.scatter_add(-1, torch.where(mine, t, 0)[..., None],
                      torch.where(mine, -1.0, 0.0)[..., None].to(p.dtype))
    return p * scale


class _VocabXentFn(torch.autograd.Function):
    """The materialized head's loss on the rank's vocab columns: logz and
    the target logit completed over the model group (`vp_combine`); the
    backward (softmax - onehot) / N on the rank's columns, in the
    logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets, comm, lo):
        lf = logits.float()
        lz, gold = vp_stats(lf, targets, lo)
        logz, gold = vp_combine(lz, gold, comm)
        ctx.save_for_backward(logits, targets, logz)
        ctx.lo = lo
        return (logz - gold).mean()

    @staticmethod
    def backward(ctx, g):
        logits, targets, logz = ctx.saved_tensors
        scale = g.float() / logz.numel()
        d = vp_grads(logits.float(), targets, ctx.lo, logz, scale)
        return d.to(logits.dtype), None, None, None


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


def _chunk_logits(xc, wf, qw=None):
    """One chunk's lm_head product with f32 results (JAX's einsum with
    preferred_element_type=f32: f32 products of the operands, f32 sums);
    wf is w in f32.  With `qw` (w's e4m3 codes and column scales, fp8
    mode "on") the chunk's `fp8_matmul` (JAX `_head_logits`)."""
    if qw is not None:
        return _fp8.fp8_matmul_q(xc, *qw)
    return torch.matmul(xc.float(), wf)


class _ChunkedXentFn(torch.autograd.Function):
    """JAX `_make_flx_variant` (:105-161): forward saves (x, w, targets,
    logz); backward recomputes each chunk's logits, dz = (softmax -
    onehot) * g/(B T) in f32, cast to x's dtype before the two products
    (:142), dx per chunk in x's dtype, dW summed in f32, then cast to w's
    dtype.  `fp8` (the mode read once, at the forward) makes both passes'
    logits the fp8 product.

    With a communicator `comm`, w is the rank's vocab columns [lo, lo +
    V_local): each chunk's logsumexp and target logit over those columns
    (`vp_stats`) are completed for every row at once (`vp_combine`: two
    all-reduces a step, not a chunk), and dz is the rank's columns' (its
    dx a partial: `copy_to` before the head sums it).  Without one the
    loss is the chunks' sum, the single-device bits."""

    @staticmethod
    def forward(ctx, x, w, targets, chunk, fp8, comm=None, lo=0):
        b, t, _ = x.shape
        lz = torch.empty((b, t), dtype=torch.float32, device=x.device)
        gold = torch.empty((b, t), dtype=torch.float32, device=x.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        wf = w.float()
        qw = _fp8._quantize_cols(w) if fp8 else None
        for c0 in range(0, t, chunk):
            logits = _chunk_logits(x[:, c0:c0 + chunk], wf, qw)
            lzc, gc = vp_stats(logits, targets[:, c0:c0 + chunk], lo)
            lz[:, c0:c0 + chunk], gold[:, c0:c0 + chunk] = lzc, gc
            if comm is None:
                loss_sum = loss_sum + (lzc - gc).sum()
        if comm is not None:
            lz, gold = vp_combine(lz, gold, comm)
            loss_sum = (lz - gold).sum()
        ctx.save_for_backward(x, w, targets, lz)
        ctx.chunk, ctx.fp8, ctx.lo = chunk, fp8, lo
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
        qw = _fp8._quantize_cols(w) if ctx.fp8 else None
        for c0 in range(0, t, chunk):
            xc = x[:, c0:c0 + chunk]
            logits = _chunk_logits(xc, wf, qw)
            p = vp_grads(logits, targets[:, c0:c0 + chunk], ctx.lo,
                         logz[:, c0:c0 + chunk], 1.0)
            # grads flow at compute precision
            pc = (p * scale).to(x.dtype).float()
            dx[:, c0:c0 + chunk] = torch.matmul(pc, wf.t()).to(x.dtype)
            dw += torch.einsum("btd,btv->dv", xc.float(), pc)
        return dx, dw.to(w.dtype), None, None, None, None, None


def _variant(want: int):
    """One fixed-target-chunk head with a stable module-level name (the
    tuner and its cache file know a winner by module + name)."""
    def flx(x, w, targets, comm=None, lo=0):
        return _ChunkedXentFn.apply(x, w, targets,
                                    _pick_chunk(x.shape[1], want),
                                    _fp8._MODE == "on", comm, lo)
    flx.__name__ = flx.__qualname__ = f"fused_linear_xent_c{want}"
    return flx


fused_linear_xent_c64 = _variant(64)
fused_linear_xent_c128 = _variant(128)
fused_linear_xent_c256 = _variant(256)
_FLX_VARIANTS = {64: fused_linear_xent_c64, 128: fused_linear_xent_c128,
                 256: fused_linear_xent_c256}
# (T, the candidate tuple) — de-duplicated by effective chunk, JAX's
# order (128 first: the tuner-less default)
_CANDS = {}


def _candidates(t: int):
    cands = _CANDS.get(t)
    if cands is None:
        out, seen = [], set()
        for want in (128, 64, 256):
            eff = _pick_chunk(t, want)
            if eff not in seen:
                seen.add(eff)
                out.append(_FLX_VARIANTS[want])
        cands = _CANDS[t] = tuple(out)
    return cands


def fused_linear_xent(x, w, targets, vocab=None):
    """Mean NLL of logits = x @ w without materializing the (B, T, V)
    logits.  x (B, T, D); w (D, V); targets (B, T) int.  The target chunk
    is the installed tuner's pick among the variants; 128 without one.
    With `vocab` = (comm, lo), w is the rank's columns [lo, lo + V_local)
    of the vocab-parallel head (module docstring); the tuner times the
    variants on the rank's own shapes, without the group (its stand-in
    targets are zeros), and the chunk of its pick runs."""
    tuner = _rt._default_tuner
    if tuner is None:
        flx = fused_linear_xent_c128
    else:
        flx = tuner.choose(_candidates(x.shape[1]), (x, w, targets))
    return flx(x, w, targets, *(vocab or ()))
