# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Paged KV cache: one preallocated pool, per-request block tables.

Counterpart of `tiny_deepspeed_tpu/serving/pool.py`.  The pool is ONE
(num_blocks + 1, block_tokens, L, KVH, Dh) K/V pair carved into
`block_tokens`-token blocks; a request owns just the blocks its length
needs, listed in its host-side block table.  Physical block 0 is SCRATCH:
never allocated, it absorbs the writes of invalid slots and
bucket-padding positions so every step stays branch-free; every read
masks by true position.

The JAX functions return a new `KVPoolView` (the compiled steps donate
the old one).  Here the writers update the pool tensors IN PLACE and
return the same view — no copy of the pool per step.  Quantized blocks
(`quant="int8" | "fp8"`) need the quantization kernel and wait for a
later slice.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Union

import torch

from ..ops.dispatch import resolve_device

# the never-allocated block absorbing invalid-slot / padding writes
SCRATCH_BLOCK = 0


class KVPoolView(NamedTuple):
    """The pool's device tensors.  k/v: (num_blocks, block_tokens, L, KVH,
    Dh) in the resting dtype; k_scale/v_scale stay None (the quantized
    pool is not ported yet)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class PageRef(NamedTuple):
    """Per-slot cache coordinates for one decode step: tables (S, W)
    physical block ids (unused entries -> SCRATCH_BLOCK), blk/off (S,)
    this token's write block and in-block offset, pos (S,) each slot's
    current length (the attention mask bound)."""

    tables: torch.Tensor
    blk: torch.Tensor
    off: torch.Tensor
    pos: torch.Tensor


def page_ref(tables, pos, block_tokens: int) -> PageRef:
    """Write coordinates, once per token outside the layer loop: position
    p lands in logical block p // block_tokens at offset p %
    block_tokens.  tables (S, W) and pos (S,) are int32 (what the paged
    kernel reads); blk/off come back int64, ready to index the pool."""
    j = torch.div(pos, block_tokens, rounding_mode="floor").long()
    blk = torch.gather(tables, 1, j[:, None])[:, 0].long()
    return PageRef(tables, blk, (pos % block_tokens).long(), pos)


def paged_append(view: KVPoolView, k, v, l: int, page: PageRef) -> KVPoolView:
    """Write one token's K/V per slot — k/v (S, KVH, Dh) — at
    (page.blk, page.off, l), in place.  Invalid slots point at scratch."""
    view.k[page.blk, page.off, l] = k.to(view.k.dtype)
    view.v[page.blk, page.off, l] = v.to(view.v.dtype)
    return view


def paged_panel(view: KVPoolView, l: int, page: PageRef):
    """Gather layer l's K/V panels through the block tables:
    (S, KVH, W * block_tokens, Dh) per side, in the pool's resting dtype."""
    tables = page.tables.long()

    def panel(pool):
        g = pool[:, :, l][tables]  # (S, W, bt, KVH, Dh)
        s, w, bt, kvh, dh = g.shape
        return g.reshape(s, w * bt, kvh, dh).transpose(1, 2)

    return panel(view.k), panel(view.v)


def paged_scatter(view: KVPoolView, ks, vs, block_ids,
                  block_tokens: int) -> KVPoolView:
    """Scatter a prefill's K/V — ks/vs (L, 1, KVH, P, Dh) — into the pool
    blocks `block_ids` ((P / block_tokens,) physical ids; padding-tail
    entries point at scratch), in place."""
    ids = block_ids.long()

    def prep(a):
        L, _, kvh, p, dh = a.shape  # one request per prefill
        a = a[:, 0].permute(2, 0, 1, 3)  # (P, L, KVH, Dh)
        return a.reshape(p // block_tokens, block_tokens, L, kvh, dh)

    view.k[ids] = prep(ks).to(view.k.dtype)
    view.v[ids] = prep(vs).to(view.v.dtype)
    return view


class PagedKVPool:
    """Host-side pool owner: the device tensors plus exact, refcounted
    block accounting (JAX pool.py:313-440).  `num_blocks` is the USABLE
    count; one scratch block is allocated on top and never handed out.
    `alloc` hands blocks out at refcount 1 in ascending order from a LIFO
    free list, `share` adds a holder, `free_blocks` drops one and returns
    a block to the free list when its last holder lets go."""

    def __init__(self, *, n_layer: int, kv_heads: int, head_dim: int,
                 num_blocks: int, block_tokens: int, dtype,
                 quant: Optional[str] = None,
                 device: Union[None, str, torch.device] = None):
        if quant is not None:
            raise ValueError(
                f"KV-cache quant={quant!r}: int8/fp8 pool blocks need the "
                "quantization kernel, not yet ported (ROADMAP.md); use "
                "quant=None")
        if num_blocks < 1 or block_tokens < 1:
            raise ValueError("num_blocks and block_tokens must be >= 1")
        self.device = resolve_device(device)
        self.num_usable = int(num_blocks)
        self.block_tokens = int(block_tokens)
        total = self.num_usable + 1  # + scratch
        shape = (total, block_tokens, n_layer, kv_heads, head_dim)
        self.view = KVPoolView(
            k=torch.zeros(shape, dtype=dtype, device=self.device),
            v=torch.zeros(shape, dtype=dtype, device=self.device))
        # pop() hands out ascending ids from 1; frees push back LIFO
        self._free: List[int] = list(range(total - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """DISTINCT allocated blocks."""
        return self.num_usable - len(self._free)

    def ref_counts(self) -> Dict[int, int]:
        return dict(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n block ids at refcount 1, or None WITHOUT allocating when fewer
        than n are free (admission is all-or-nothing)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        return ids

    def share(self, ids: List[int]) -> None:
        """Add one holder to each allocated block in `ids`."""
        for b in ids:
            if self._ref.get(b, 0) < 1:
                raise ValueError(
                    f"cannot share block {b}: not allocated (a free "
                    "block's contents are reusable garbage)")
        for b in ids:
            self._ref[b] += 1

    def free_blocks(self, ids: List[int]) -> None:
        """Drop one holder per id; a block whose last holder lets go
        returns to the free list (LIFO, in `ids` order)."""
        drops = Counter(int(b) for b in ids)
        for b, n in drops.items():
            if not 1 <= b <= self.num_usable:
                raise ValueError(f"freeing invalid block id {b}")
            if self._ref.get(b, 0) < n:
                raise ValueError(
                    f"double free of block {b}: {n} release(s) against "
                    f"refcount {self._ref.get(b, 0)}")
        for b in ids:
            b = int(b)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)
