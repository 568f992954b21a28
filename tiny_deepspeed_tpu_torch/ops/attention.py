# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Causal self-attention: standard (materialized mask) and flash.

Counterpart of `tiny_deepspeed_tpu/ops/attention.py`.  Both take
(B, H, T, Dh) queries and (B, KVH, T, Dh) keys/values with KVH | H.
`flash_attention` launches the FA2 kernel (ops/flash_fa2.py) on CUDA
tensors and takes the plain version on CPU tensors; there is no SDPA
fallback.  The JAX package's mesh-aware `sharded_attention` (ring,
Ulysses, shard_map) has no counterpart yet: the port runs one device.
"""

from __future__ import annotations

from .flash_fa2 import _fa2_fwd_plain, fa2_flash_attention_fwd


def standard_attention(q, k, v):
    """Causal softmax(QK^T/sqrt(d))V with an explicit mask (JAX :35)."""
    return _fa2_fwd_plain(q, k, v)[0]


def flash_attention(q, k, v):
    """Blockwise causal attention: the FA2 kernel on the card."""
    return fa2_flash_attention_fwd(q, k, v)[0]


ATTENTION = {"standard_attention": standard_attention,
             "flash_attention": flash_attention}
