# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Causal self-attention: standard (materialized mask) and flash.

Counterpart of `tiny_deepspeed_tpu/ops/attention.py`.  Both take
(B, H, T, Dh) queries and (B, KVH, T, Dh) keys/values with KVH | H.
`flash_attention` is `FA2Fn`: the FA2 forward and backward kernels
(ops/flash_fa2.py) on CUDA tensors, their plain versions on CPU tensors;
there is no SDPA fallback.  `standard_attention` stays plain PyTorch and
autograd differentiates it, as XLA does in the JAX package.  The JAX
package's mesh-aware `sharded_attention` (ring, Ulysses, shard_map) has
no counterpart yet: the port runs one device.
"""

from __future__ import annotations

from .flash_fa2 import FA2Fn, _fa2_fwd_plain


def standard_attention(q, k, v):
    """Causal softmax(QK^T/sqrt(d))V with an explicit mask (JAX :35)."""
    return _fa2_fwd_plain(q, k, v)[0]


def flash_attention(q, k, v):
    """Blockwise causal attention: the FA2 kernels on the card."""
    return FA2Fn.apply(q, k, v)


ATTENTION = {"standard_attention": standard_attention,
             "flash_attention": flash_attention}
