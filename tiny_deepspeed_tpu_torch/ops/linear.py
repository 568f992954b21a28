# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Linear layer, JAX-package layout: weights are (in, out).

Counterpart of `tiny_deepspeed_tpu/ops/linear.py` (`linear_forward`,
:40-67, and the `custom_vjp` at :131-154).  A plain matrix product
outside any kernel stays a library call here, as the JAX package left it
to XLA, and PyTorch autograd through `torch.matmul` is the backward of
the plain candidates: no `autograd.Function` is needed there, because
the JAX rule computes the same products — dx = gy w^T and dw = x^T gy
(leading dims contracted, f32 accumulation), db = sum gy — and autograd
gives them the same dtypes: on the card cuBLAS accumulates bf16 products
in f32 and emits dw in x's dtype, as the JAX rule casts it (:114), and
the cast of the f32 master into the compute dtype carries dw back into
the master's dtype (:148).

The dispatch site is JAX's (`linear_forward`, :40-67; `_CANDIDATES_FWD`
:125): `_fwd_batched` (`torch.matmul` on the 3-D input; JAX `_fwd_xla`)
is candidate 0, `_fwd_flat2d` (leading dims flattened into one 2-D
product; JAX `_fwd_xla_flat2d`) the second; the installed runtime tuner
(autotuner/) picks one per (shape, dtype).  fp8 (ops/matmul_fp8.py):
mode "candidate" appends `_fwd_fp8`, mode "on" forces it (its backward
is `Fp8LinearFn`'s closed form).  With no tuner and mode "off" `linear`
runs exactly `_fwd_batched`'s ops — the path it ran before the site
existed.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..autotuner import runtime_tuner as _rt
from . import matmul_fp8 as _fp8


def _fwd_batched(x, w, b):
    """y = x @ w (+ b) in x's dtype: one `torch.matmul` on the batched
    input (bf16 products accumulate in f32 inside cuBLAS, PyTorch's
    default, the counterpart of JAX's `preferred_element_type=float32`)."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _fwd_flat2d(x, w, b):
    """The same product with the leading dims flattened into one 2-D
    matmul (JAX `_fwd_xla_flat2d`, :84-96)."""
    y = torch.matmul(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    y = y.reshape(*x.shape[:-1], w.shape[-1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y


_CANDIDATES_FWD = (_fwd_batched, _fwd_flat2d)
_CANDIDATES_FP8 = _CANDIDATES_FWD + (_fp8._fwd_fp8,)


def linear_forward(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None,
                   tuner=None) -> torch.Tensor:
    """y[..., out] = x[..., in] @ w[in, out] (+ b[out]), in x's dtype,
    through the candidate the tuner (`tuner`, else the process default)
    picks; candidate 0 without one."""
    mode = _fp8._MODE
    if mode == "on":
        return _fp8._fwd_fp8(x, w, b)
    if tuner is None:
        tuner = _rt._default_tuner
        if tuner is None and mode == "off":
            return _fwd_batched(x, w, b)
    cands = _CANDIDATES_FWD if mode == "off" else _CANDIDATES_FP8
    impl = tuner.choose(cands, (x, w, b)) if tuner else cands[0]
    return impl(x, w, b)


linear = linear_forward
