# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Speculative decoding over the continuous-batching scheduler.

Counterpart of `tiny_deepspeed_tpu/serving/spec.py` (:49-136).  A
drafter (serving/drafter.py) proposes up to K continuation tokens per
slot and ONE target pass scores all K+1 span positions per slot at once
(Leviathan et al., arXiv:2211.17192); each verify commits 1 to K+1
tokens.  The verify step, in order:

  1. the span embeds at its per-(slot, offset) positions, clamped to
     block_size - 1;
  2. `paged_verify` reads the COMMITTED prefix through the block tables
     (the pool is read-only here) while the span attends to itself under
     the windowed causal mask — on the card, the span-verify kernel;
  3. `head_span` scores every offset; the poison operand and the
     per-slot non-finite flag cover the whole span;
  4. `spec_accept_per_slot` decides how many drafts commit;
  5. the K/V commit count is the accepted prefix (head + accepted
     drafts), clamped to the request's K/V horizon;
  6. `paged_append_span` writes exactly that prefix's K/V, after
     acceptance — rejected offsets land in the scratch block, so nothing
     speculative ever rests in the pool.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.sampling import spec_accept_per_slot
from .drafter import make_drafter
from .pool import page_ref, paged_append_span

# hard ceiling on the draft span
MAX_SPEC_K = 16


class SpecDecoder:
    """One engine's speculative-decoding state: the drafter and the
    verify step.  Everything positional comes from the engine's slots at
    each call, which keeps preemption and restart composition free."""

    def __init__(self, model, config, *, max_seq: int):
        k = int(config.spec_k)
        if not 1 <= k <= MAX_SPEC_K:
            raise ValueError(
                f"spec_k={config.spec_k} out of range [1, {MAX_SPEC_K}]")
        self.k = k
        self.model = model
        self.config = config
        self.drafter = make_drafter(
            config.spec_draft, model, k, max_active=config.max_active,
            max_seq=max_seq, block_tokens=config.block_tokens,
            seed=config.seed)

    def describe(self) -> str:
        return f"spec(k={self.k}, drafter={self.drafter.describe()})"

    def propose(self, slots) -> np.ndarray:
        """(S, K+1) proposals: K verifiable drafts + the bonus's."""
        return self.drafter.propose(slots)

    def on_admit(self, slot_i: int, prompt_now) -> int:
        return self.drafter.on_admit(slot_i, prompt_now)

    @torch.no_grad()
    def verify(self, stacked, head, view, spanx, pos0, tables, seeds, nprod,
               limit_kv, poison):
        """spanx (S, K+2) = [committed head, d_1..d_K, extra]; pos0 (S,)
        the head's position; limit_kv (S,) the last position whose K/V
        the request will ever need (-1 for empty slots).  Returns
        (accepted (S,), final (S,), bad (S,)) on the device; the pool
        gains the accepted prefix's K/V in place."""
        model, cfg, k1 = self.model, self.config, self.k + 1
        dev = view.k.device
        span = torch.from_numpy(spanx[:, :k1]).to(dev)
        extra = spanx[:, k1]
        pos0_t = torch.from_numpy(pos0).to(dev)
        tables_t = torch.from_numpy(tables).to(dev)
        positions = torch.clamp(
            pos0_t.long()[:, None] + torch.arange(k1, device=dev)[None, :],
            max=model.config.block_size - 1)
        x = model._embed_decode_span(span, positions)
        page = page_ref(tables_t, pos0_t, cfg.block_tokens)
        x, sks, svs = model.paged_verify(stacked, x, view, page)
        logits = model.head_span(x, params=head)
        if np.isnan(poison).any():
            logits = logits + torch.from_numpy(poison).to(dev)[:, None, None]
        bad = ~torch.isfinite(logits).all(dim=2).all(dim=1)
        acc, final = spec_accept_per_slot(
            logits, span, extra, cfg.seed, seeds, nprod, cfg.temperature,
            cfg.top_k)
        # the K/V commit count: head + accepted drafts, clamped to the
        # request's horizon — the final token's K/V is next tick's head
        horizon = torch.clamp(
            torch.from_numpy(limit_kv).to(dev).long() + 1 - pos0_t.long(),
            min=0)
        count = torch.minimum(acc + 1, horizon)
        paged_append_span(view, sks, svs, tables_t, pos0_t, count,
                          cfg.block_tokens)
        return acc, final, bad
