# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Softmax cross-entropy with integer targets, computed in float32.

Counterpart of `tiny_deepspeed_tpu/ops/softmax_xent.py::
softmax_cross_entropy` (:20-27): a numerically stable logsumexp minus the
gold logit, mean-reduced over all positions; autograd differentiates it,
as XLA does.  The chunked `fused_linear_xent` (never materializing the
(B, T, V) logits) and the Pallas fused head (`ops/xent_pallas.py`) belong
to the next slice of the port, and `GPTConfig(fused_xent=True)` is
refused until then.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL.  logits (..., V) any float dtype; targets (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None]).squeeze(-1)
    return (logz - gold).mean()
