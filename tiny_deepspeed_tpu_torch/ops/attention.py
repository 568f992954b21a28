# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Causal self-attention: standard (materialized mask) and flash.

Counterpart of `tiny_deepspeed_tpu/ops/attention.py`.  Both take
(B, H, T, Dh) queries and (B, KVH, T, Dh) keys/values with KVH | H.
`flash_attention` is `FA2Fn`: the FA2 forward and backward kernels
(ops/flash_fa2.py) on CUDA tensors, their plain versions on CPU tensors;
there is no SDPA fallback.  `standard_attention` stays plain PyTorch and
autograd differentiates it, as XLA does in the JAX package.

`sharded_attention` is the counterpart of the JAX dispatch (:111-210)
for the paths the port runs: without a sequence split, `ATTENTION[impl]`
on the rank's whole sequence; with one (`pctx.seq_size > 1`), ring
attention over the seq group (parallel/ring_attention.py) — through the
FA2 chunk kernels for "flash_attention", through their plain versions
for "standard_attention" (JAX's ring likewise keeps the latter
kernel-free).  K/V stay at KVH heads on the ring.  Ulysses is not ported
(parallel/mesh.make_context refuses it).
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


def sharded_attention(q, k, v, impl: str, pctx=None):
    """Causal attention of this rank's (B, H, T, Dh) queries and (B, KVH,
    T, Dh) keys/values under `pctx` (parallel/mesh.ParallelContext; None
    for one device): the ring over the seq group when it splits the
    sequence, else `ATTENTION[impl]`."""
    if pctx is None or pctx.seq_size == 1:
        return ATTENTION[impl](q, k, v)
    from ..parallel.ring_attention import ring_attention
    return ring_attention(q, k, v, pctx.seq_comm,
                          kernels=impl == "flash_attention")
