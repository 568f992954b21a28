# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Linear layer, JAX-package layout: weights are (in, out).

Counterpart of `tiny_deepspeed_tpu/ops/linear.py` (`linear_forward` and
the `custom_vjp` at :131-154).  A plain matrix product outside any kernel
stays a library call here, as the JAX package left it to XLA, and PyTorch
autograd through `torch.matmul` is the backward: no `autograd.Function`
is needed, because the JAX rule computes the same products —
dx = gy w^T and dw = x^T gy (leading dims contracted, f32 accumulation),
db = sum gy — and autograd gives them the same dtypes: on the card cuBLAS
accumulates bf16 products in f32 and emits dw in x's dtype, as the JAX
rule casts it (:114), and the cast of the f32 master into the compute
dtype carries dw back into the master's dtype (:148).
"""

from __future__ import annotations

from typing import Optional

import torch


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[..., out] = x[..., in] @ w[in, out] (+ b[out]), in x's dtype.

    bf16 products accumulate in f32 inside cuBLAS (PyTorch's default), the
    counterpart of the JAX package's `preferred_element_type=float32`."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y
