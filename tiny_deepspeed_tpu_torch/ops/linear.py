# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Linear forward, JAX-package layout: weights are (in, out).

Counterpart of `tiny_deepspeed_tpu/ops/linear.py::linear_forward`.  A plain
matrix product outside any kernel stays a library call here, as the JAX
package left it to XLA; the backward waits for the training slice.
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
