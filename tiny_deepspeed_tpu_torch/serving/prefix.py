# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Shared-prefix KV reuse: a radix tree of committed full blocks over
the refcounted paged pool.

Counterpart of `tiny_deepspeed_tpu/serving/prefix.py` (:51-228), pure
Python and line for line the same algorithm.  A position's K/V is a
pure function of the token prefix up to it, so two prompts sharing
their first m * block_tokens tokens can share the physical blocks
holding those positions:

  * the tree is a RADIX over per-block token tuples: one node per
    committed FULL block, children keyed by the next block's tokens.
    Matching a prompt walks from the root block by block; the matched
    blocks alias into the new request's block table (`pool.share`) and
    only the unmatched SUFFIX pays a prefill;
  * only full blocks entirely BEHIND the request's last prompt position
    are aliased, so every block the request will write is private —
    shared blocks are read-only by construction;
  * the tree holds one refcount per node, which keeps a finished
    request's prompt blocks warm.  Under pool pressure `evict` drops
    leaves whose block has no other holder, least recently hit first; an
    interior node never drops before its children.

The tree never touches device memory: blocks stay in the pool, the tree
holds ids.  A warm restart rebuilds pool and tree from empty.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    """One committed full block: `key` is the block's token tuple (the
    edge from the parent), `block` the physical id the tree holds one
    refcount on, `last_hit` the scheduler tick of the last match/insert
    through this node (the LRU eviction key)."""

    __slots__ = ("key", "block", "children", "parent", "last_hit")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"], last_hit: int):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_hit = last_hit


class PrefixCache:
    """Radix tree of committed full blocks keyed by token prefix."""

    def __init__(self, block_tokens: int):
        self.block_tokens = int(block_tokens)
        self._root = _Node((), -1, None, 0)  # sentinel, holds no block
        self._nodes = 0
        # lifetime counters (the engine's `prefix_stats` reads these;
        # advanced by `note_admission` on LANDED admissions only)
        self.hits = 0          # admissions that aliased >= 1 block
        self.misses = 0        # admissions that aliased none
        self.blocks_aliased = 0
        self.tokens_avoided = 0
        self.prompt_tokens = 0  # total prompt tokens at admissions
        self.evicted = 0

    def __len__(self) -> int:
        return self._nodes

    def reset_stats(self) -> None:
        """Zero the lifetime counters WITHOUT touching the tree: warm-up
        requests may warm the tree but must not inflate a measured
        pass's hit-rate stats."""
        self.hits = self.misses = 0
        self.blocks_aliased = self.tokens_avoided = 0
        self.prompt_tokens = self.evicted = 0

    def _chunks(self, tokens: Sequence[int], n_blocks: int):
        bt = self.block_tokens
        for i in range(n_blocks):
            yield tuple(int(t) for t in tokens[i * bt:(i + 1) * bt])

    # -- lookup -------------------------------------------------------------

    def match(self, tokens: Sequence[int], *, limit: int,
              tick: int) -> List[int]:
        """Physical block ids of the longest cached full-block prefix
        of `tokens`, at most `limit` blocks (the caller caps at
        (p-1)//block_tokens so at least one prompt token is always left
        for the suffix prefill — which is also what keeps every
        writable block private).  Refreshes last_hit along the matched
        path.  The caller must `pool.share` the returned ids before
        any allocation that could trigger eviction, and calls
        `note_admission` once the admission actually lands — a match
        whose admission rolls back on pool exhaustion never counts
        (the hit-rate stats describe work AVOIDED, not work found)."""
        node = self._root
        out: List[int] = []
        for chunk in self._chunks(tokens, limit):
            nxt = node.children.get(chunk)
            if nxt is None:
                break
            nxt.last_hit = tick
            out.append(nxt.block)
            node = nxt
        return out

    def note_admission(self, n_aliased: int, prompt_tokens: int) -> None:
        """Record one LANDED admission's cache outcome (the engine
        calls this after the prefill succeeds)."""
        if n_aliased:
            self.hits += 1
            self.blocks_aliased += n_aliased
            self.tokens_avoided += n_aliased * self.block_tokens
        else:
            self.misses += 1
        self.prompt_tokens += prompt_tokens

    # -- insert -------------------------------------------------------------

    def insert(self, tokens: Sequence[int], table: Sequence[int], pool,
               *, tick: int) -> int:
        """Commit the FULL blocks of an admitted request's prompt:
        `table[i]` holds tokens[i*bt:(i+1)*bt] for every full block
        (the caller passes exactly len(tokens)//bt table entries).  New
        nodes take one `pool.share` refcount each — the tree's own
        ownership, independent of the request's table.  A path already
        present keeps its EXISTING block (the contents are the same by
        the prefix-determinism argument; dropping the duplicate spares
        a redundant warm block) and just refreshes last_hit.  Returns
        the number of new nodes."""
        bt = self.block_tokens
        n = min(len(tokens) // bt, len(table))
        node = self._root
        added = 0
        for i, chunk in enumerate(self._chunks(tokens, n)):
            if len(chunk) < bt:
                break
            nxt = node.children.get(chunk)
            if nxt is None:
                pool.share([table[i]])
                nxt = _Node(chunk, int(table[i]), node, tick)
                node.children[chunk] = nxt
                self._nodes += 1
                added += 1
            else:
                nxt.last_hit = tick
            node = nxt
        return added

    # -- eviction -----------------------------------------------------------

    def _leaves(self) -> List[_Node]:
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, pool, *, need: int) -> int:
        """Drop unreferenced leaves (block refcount == 1 — the tree is
        the only holder, so freeing actually returns a block) LRU by
        last_hit until `need` blocks freed or nothing droppable
        remains.  ONE leaf scan seeds a heap; a drop that leaves its
        parent childless pushes the parent as a new candidate (its
        eligibility re-checked at pop — alloc-failure paths call this
        repeatedly, so the per-call work must stay O(leaves log
        leaves + freed), not O(leaves x freed)).  Returns blocks
        freed."""
        import heapq
        heap = [(n.last_hit, n.block, n) for n in self._leaves()]
        heapq.heapify(heap)
        freed = 0
        while freed < need and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.children or pool.refcount(victim.block) != 1:
                continue  # grew children / still referenced: skip
            parent = victim.parent
            del parent.children[victim.key]
            pool.free_blocks([victim.block])
            self._nodes -= 1
            self.evicted += 1
            freed += 1
            if parent is not self._root and not parent.children:
                heapq.heappush(heap,
                               (parent.last_hit, parent.block, parent))
        return freed

    # -- introspection ------------------------------------------------------

    def blocks(self) -> List[int]:
        """Every block id the tree currently holds a refcount on."""
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.block)
            stack.extend(n.children.values())
        return out

    def reclaimable(self, pool) -> int:
        """Blocks the tree could hand back under pressure right now
        (held by the tree alone) — what the pool-watermark shed check
        subtracts from raw utilization: warm cache must not read as
        overload."""
        return sum(1 for b in self.blocks() if pool.refcount(b) == 1)
