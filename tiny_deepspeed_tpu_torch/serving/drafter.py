# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Draft-token proposers for speculative decoding (serving/spec.py).

Counterpart of `tiny_deepspeed_tpu/serving/drafter.py`.  Two drafters
behind one interface: `propose(slots) -> (S, K+1)` proposals per decode
slot (K verifiable drafts + the bonus position's proposal, each
conditioned on the ones before it, so any position's proposal is a pure
function of the committed prefix), and `on_admit(slot_i, prompt_now)`,
fired at every (re)admission, which rebuilds the drafter's slot state
from the committed prefix and returns its proposal for the first
post-prefix position (the spec prefill's accept-or-residual operand):

  * `NgramDrafter` ("ngram") — model-free prompt lookup: propose the
    continuation of the most recent earlier occurrence of the context's
    own suffix n-gram.  No weights, no device work.
  * `ModelDrafter` ("model:self" / "model:<preset>") — a same-family
    model with its OWN paged pool, statically tabled (slot s owns blocks
    [1 + s*W, (s+1)*W]), written through the model's `paged_prefill` /
    `paged_decode` (so on the card it launches the prefill kernels and
    the paged decode kernel).  Each tick one (K+1)-step greedy rollout
    proposes for every slot; its first step embeds the committed head
    token, which also overwrites a rejected draft's stale K/V there.

Both propose deterministically (argmax / lookup): a point-mass proposal,
so the acceptance rule stays target-exact.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .pool import SCRATCH_BLOCK, PagedKVPool, PageRef


class NgramDrafter:
    """Prompt-lookup decoding (JAX :55-129): match the context's trailing
    n-gram (longest first, `max_n` down to `min_n`) against its most
    recent earlier occurrence and propose what followed; no match pads
    with the last token (the verify step rejects bad guesses)."""

    def __init__(self, k: int, max_n: int = 3, min_n: int = 1):
        if k < 1:
            raise ValueError("drafter k must be >= 1")
        if not 1 <= min_n <= max_n:
            raise ValueError("need 1 <= min_n <= max_n")
        self.k = int(k)
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def describe(self) -> str:
        return f"ngram(n<={self.max_n})"

    def on_admit(self, slot_i: int, prompt_now: List[int]) -> int:
        t = self._lookup_next(prompt_now, self.max_n, self.min_n)
        return int(t if t is not None else
                   (prompt_now[-1] if prompt_now else 0))

    @staticmethod
    def _lookup_next(ctx: List[int], max_n: int, min_n: int):
        """The token after the most recent earlier occurrence of ctx's
        trailing n-gram (longest n first), or None."""
        n_ctx = len(ctx)
        for n in range(min(max_n, n_ctx - 1), min_n - 1, -1):
            pat = ctx[-n:]
            for start in range(n_ctx - n - 1, -1, -1):
                if ctx[start:start + n] == pat:
                    return ctx[start + n]
        return None

    def propose_one(self, ctx: List[int]) -> List[int]:
        """K+1 proposals, proposal j looked up on ctx extended by
        proposals 1..j-1."""
        ext = list(ctx)
        out: List[int] = []
        for _ in range(self.k + 1):
            t = self._lookup_next(ext, self.max_n, self.min_n)
            if t is None:
                t = ext[-1] if ext else 0
            out.append(t)
            ext.append(t)
        return out

    def propose(self, slots) -> np.ndarray:
        """(S, K+1) proposals; empty slots propose zeros."""
        drafts = np.zeros((len(slots), self.k + 1), np.int64)
        for i, s in enumerate(slots):
            if s is not None:
                drafts[i] = self.propose_one(s.req.prompt + s.req.tokens)
        return drafts


class ModelDrafter:
    """Small-model drafter over its own statically tabled paged pool
    (JAX :132-273).  After a tick committing `a` drafts + one resampled
    token the pool holds the drafter's K/V for every committed position;
    (re)admission prefills the slot's region from prompt + produced."""

    def __init__(self, model, k: int, *, max_active: int, max_seq: int,
                 block_tokens: int):
        if k < 1:
            raise ValueError("drafter k must be >= 1")
        if not getattr(model, "paged_decode_capable", False):
            raise ValueError(f"draft model {type(model).__name__} is not "
                             "paged-decode capable")
        from ..models.gpt2 import resolved_cache_dtype
        c = model.config
        if c.block_size < max_seq:
            raise ValueError(
                f"draft model context block_size={c.block_size} is smaller "
                f"than the engine's max_seq_tokens={max_seq}: the drafter "
                "must prefill any committed prefix the engine can hold")
        self.model = model
        self.device = model.device
        self.k = int(k)
        self._bt = int(block_tokens)
        self.max_seq = min(int(max_seq), c.block_size)
        self._W = w = -(-self.max_seq // self._bt)
        self.pool = PagedKVPool(
            n_layer=c.n_layer, kv_heads=getattr(c, "kv_heads", c.n_head),
            head_dim=c.head_dim, num_blocks=max_active * w,
            block_tokens=self._bt, dtype=resolved_cache_dtype(c),
            device=self.device)
        self._tables = torch.tensor(
            [[1 + s * w + j for j in range(w)] for s in range(max_active)],
            dtype=torch.int32, device=self.device)
        with torch.no_grad():
            self._stacked = model.stacked_compute_params()
            self._head = model.head_compute_params()

    def describe(self) -> str:
        c = self.model.config
        return f"model({c.n_layer}L{c.n_embd}D)"

    @torch.no_grad()
    def _rollout(self, tok, pos):
        """K+1 greedy decode steps for every slot at once: (S,) head
        tokens at (S,) positions -> (S, K+1) proposals.  Positions at or
        past the horizon write to scratch and clamp their reads (the
        verify step rejects what such a slot proposes)."""
        bt, w, ms = self._bt, self._W, self.max_seq
        tables = self._tables
        out = []
        for _ in range(self.k + 1):
            safe = torch.clamp(pos, max=ms - 1)
            x = self.model._embed_decode(tok, safe)
            j = torch.clamp(torch.div(pos, bt, rounding_mode="floor"),
                            max=w - 1).long()
            blk = torch.gather(tables, 1, j[:, None])[:, 0].long()
            blk = torch.where(pos < ms, blk, SCRATCH_BLOCK)
            page = PageRef(tables, blk, (pos % bt).long(), safe)
            x, _ = self.model.paged_decode(self._stacked, x, self.pool.view,
                                           page)
            logits = self.model.head(x, params=self._head)[:, 0]
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1)

    def _bucket(self, p: int) -> int:
        nb = -(-p // self._bt)
        b = 1
        while b < nb:
            b *= 2
        return min(b * self._bt, self.model.config.block_size)

    def on_admit(self, slot_i: int, prompt_now: List[int]) -> int:
        """(Re)build slot_i's drafter cache from the committed prefix;
        returns the draft model's greedy proposal for the first
        post-prefix position."""
        p = len(prompt_now)
        bucket = self._bucket(p)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :p] = torch.tensor(prompt_now)
        block_ids = torch.full((bucket // self._bt,), SCRATCH_BLOCK,
                               dtype=torch.long, device=self.device)
        n = min(len(block_ids), self._W)
        block_ids[:n] = self._tables[slot_i, :n]
        logits, _ = self.model.paged_prefill(
            padded.to(self.device), p - 1, block_ids, self.pool.view,
            self._bt, stacked=self._stacked, head_params=self._head)
        return int(torch.argmax(logits[0]))

    def propose(self, slots) -> np.ndarray:
        s_count = len(slots)
        tok = np.zeros((s_count,), np.int64)
        # empty slots park at the horizon: scratch writes, clamped reads
        pos = np.full((s_count,), self.max_seq, np.int32)
        for i, s in enumerate(slots):
            if s is not None:
                tok[i] = s.last
                pos[i] = s.pos
        drafts = self._rollout(torch.from_numpy(tok).to(self.device),
                               torch.from_numpy(pos).to(self.device))
        return drafts.cpu().numpy()


def make_drafter(spec: str, model, k: int, *, max_active: int, max_seq: int,
                 block_tokens: int, seed: int = 0):
    """Drafter factory for the `spec_draft` knob (JAX :275-322):

      * "ngram"          -> NgramDrafter;
      * "model:self"     -> ModelDrafter over the TARGET model (every
                            rollout step costs a full target pass: an
                            acceptance ceiling, never a speedup);
      * "model:<preset>" -> ModelDrafter over a seeded random-init
                            `ALL_PRESETS[<preset>]` (either family, built
                            by `build_model`) sharing the target's
                            vocab, on the target's device (random weights
                            exercise the machinery; a speedup needs a
                            trained drafter).
    """
    if spec == "ngram":
        return NgramDrafter(k)
    if spec.startswith("model:"):
        name = spec[len("model:"):]
        if name == "self":
            dmodel = model
        else:
            from ..models import ALL_PRESETS, build_model
            if name not in ALL_PRESETS:
                raise ValueError(
                    f"unknown draft preset {name!r}; spec_draft takes "
                    "'ngram', 'model:self', or 'model:<preset>' with a "
                    f"preset in {sorted(ALL_PRESETS)}")
            cfg = ALL_PRESETS[name]
            if cfg.vocab_size != model.config.vocab_size:
                raise ValueError(
                    f"draft preset {name!r} has vocab_size "
                    f"{cfg.vocab_size} but the target serves "
                    f"{model.config.vocab_size}: drafts are token ids, the "
                    "vocabularies must match")
            dmodel = build_model(cfg, device=model.device).init(
                torch.Generator().manual_seed(seed))
        return ModelDrafter(dmodel, k, max_active=max_active,
                            max_seq=max_seq, block_tokens=block_tokens)
    raise ValueError(f"spec_draft {spec!r} not understood: use 'ngram', "
                     "'model:self', or 'model:<preset>'")
