# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Embedding gather and the `max_norm` row renorm.

Counterpart of `tiny_deepspeed_tpu/ops/embedding.py`.  The gather is
`F.embedding`, and PyTorch autograd through it is the backward: the JAX
rule's scatter-add weight gradient (:30-36, f32 sums cast to the
gradient's dtype — f32, since the gather reads the f32 master) is what
`F.embedding`'s backward computes, so no `autograd.Function` is needed.
Like the JAX package, `renorm_weight` is functional: it returns rescaled
rows and never mutates the stored table; autograd differentiates the
rescale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def embedding(idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., d] = w[idx]."""
    return F.embedding(idx, w)


def renorm_weight(w: torch.Tensor, max_norm: float,
                  norm_type: float = 2.0) -> torch.Tensor:
    """w with rows scaled so ||row||_p <= max_norm."""
    wf = w.float()
    norms = torch.linalg.vector_norm(wf, ord=norm_type, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return (wf * scale).to(w.dtype)
