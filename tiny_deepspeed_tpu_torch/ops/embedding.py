# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Embedding gather and the `max_norm` row renorm.

Counterpart of `tiny_deepspeed_tpu/ops/embedding.py` (forward only; the
scatter-add weight gradient waits for the training slice).  Like the JAX
package, `renorm_weight` is functional: it returns rescaled rows and never
mutates the stored table.
"""

from __future__ import annotations

import torch


def embedding(idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., d] = w[idx]."""
    return w[idx]


def renorm_weight(w: torch.Tensor, max_norm: float,
                  norm_type: float = 2.0) -> torch.Tensor:
    """w with rows scaled so ||row||_p <= max_norm."""
    wf = w.float()
    norms = torch.linalg.vector_norm(wf, ord=norm_type, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return (wf * scale).to(w.dtype)
