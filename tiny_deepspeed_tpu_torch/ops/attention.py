# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Causal self-attention: standard (materialized mask) and flash.

Counterpart of `tiny_deepspeed_tpu/ops/attention.py`.  Both take
(B, H, T, Dh) queries and (B, KVH, T, Dh) keys/values with KVH | H.
`flash_attention` is `FA2Fn`: the FA2 forward and backward kernels
(ops/flash_fa2.py) on CUDA tensors, their plain versions on CPU tensors;
there is no SDPA fallback.  `standard_attention` stays plain PyTorch and
autograd differentiates it, as XLA does in the JAX package.

`sharded_attention` is the counterpart of the JAX dispatch (:162-222)
for the paths the port runs: without a sequence split, `ATTENTION[impl]`
on the rank's whole sequence; with one (`pctx.seq_size > 1`), by
`pctx.seq_impl`:

- "ring": ring attention over the seq group (parallel/ring_attention.py)
  — through the FA2 chunk kernels for "flash_attention", through their
  plain versions for "standard_attention" (JAX's ring likewise keeps
  the latter kernel-free).  K/V stay at KVH heads on the ring;
- "ulysses": `parallel/ulysses.ulysses_attention` with `ATTENTION[impl]`
  as its local attention — on the card the causal FA2 kernels on whole
  sequences.  K/V cross the all-to-alls at KVH heads when the seq size
  divides KVH and impl is "flash_attention" (JAX's `gqa_ulysses`,
  :176-180); otherwise they are expanded to H heads first (JAX's
  `_expand`, a repeat of each K/V head over its group).
"""

from __future__ import annotations

from ..autotuner import runtime_tuner as _rt
from .flash_fa2 import FA2Fn, _fa2_fwd_plain


def standard_attention(q, k, v):
    """Causal softmax(QK^T/sqrt(d))V with an explicit mask (JAX :35)."""
    return _fa2_fwd_plain(q, k, v)[0]


def _fa2_flash(q, k, v):
    """The FA2 forward and backward kernels (#4-#6) through `FA2Fn`."""
    return FA2Fn.apply(q, k, v)


# JAX's flash site (`_tuned_pallas_flash`, :58-79) offers FLASH_VARIANTS:
# the FA2 kernel and variants of its bundled TPU kernel, which is not in
# the repo.  Here the site has one candidate, so `choose` returns it
# untimed (JAX's single-candidate shortcut) and records no key.
_FLASH_CANDIDATES = (_fa2_flash,)


def flash_attention(q, k, v):
    """Blockwise causal attention: the FA2 kernels on the card."""
    tuner = _rt._default_tuner
    if tuner is None:
        return _fa2_flash(q, k, v)
    return tuner.choose(_FLASH_CANDIDATES, (q, k, v))(q, k, v)


ATTENTION = {"standard_attention": standard_attention,
             "flash_attention": flash_attention}


def sharded_attention(q, k, v, impl: str, pctx=None):
    """Causal attention of this rank's (B, H, T, Dh) queries and (B, KVH,
    T, Dh) keys/values under `pctx` (parallel/mesh.ParallelContext; None
    for one device): the ring or Ulysses over the seq group when it
    splits the sequence, else `ATTENTION[impl]`."""
    if pctx is None or pctx.seq_size == 1:
        return ATTENTION[impl](q, k, v)
    if pctx.seq_impl == "ulysses":
        from ..parallel.ulysses import ulysses_attention
        rep = q.shape[1] // k.shape[1]
        if rep > 1 and not (impl == "flash_attention"
                            and k.shape[1] % pctx.seq_size == 0):
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        return ulysses_attention(q, k, v, pctx.seq_comm, ATTENTION[impl])
    from ..parallel.ring_attention import ring_attention
    return ring_attention(q, k, v, pctx.seq_comm,
                          kernels=impl == "flash_attention")
