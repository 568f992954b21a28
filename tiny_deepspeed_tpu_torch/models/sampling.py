# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The one sampling core: final-position logits -> next tokens.

Counterpart of `tiny_deepspeed_tpu/models/sampling.py` (the plain-decode
half; the speculative accept-or-residual rule waits for the spec slice).
Greedy decoding (temperature 0) is argmax with the first index on ties,
token-exact with the JAX package.  For temperature > 0 each draw is a
Gumbel-max over a `torch.Generator` seeded from (engine seed, request
seed, output position) only — never from the tick, the batch or the
preemption count — so a resumed request re-samples the same tokens.  It
does not reproduce JAX's random bits.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: decorrelates neighbouring seeds."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_position_seed(base_seed: int, seed: int, position: int) -> int:
    """The generator seed of output `position` of the request seeded
    `seed` under engine seed `base_seed` (63 bits)."""
    return _mix(_mix(_mix(int(base_seed)) ^ int(seed)) ^ int(position)) >> 1


def _top_k_filter(logit, top_k: Optional[int]):
    """-inf everything below each row's k-th logit."""
    if top_k is None:
        return logit
    kth = torch.topk(logit, top_k, dim=-1).values[..., -1:]
    return logit.masked_fill(logit < kth, float("-inf"))


def sample_logits(logit, generator: Optional[torch.Generator],
                  temperature: float, top_k: Optional[int] = None):
    """(B, V) float32 logits -> (B,) int64 tokens.  temperature == 0 is
    greedy argmax (generator unused); otherwise a Gumbel-max draw over
    logits / temperature restricted to the top_k logits."""
    logit = _top_k_filter(logit, top_k)
    if temperature == 0.0:
        return torch.argmax(logit, dim=-1)
    if generator is None:
        raise ValueError("temperature > 0 needs an explicit generator")
    u = torch.rand(logit.shape, generator=generator, device=logit.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logit / temperature + gumbel, dim=-1)


def sample_logits_at(logit, base_seed: int, seed: int, position: int,
                     temperature: float, top_k: Optional[int] = None):
    """(B, V) logits sampled under the (seed, position) request stream —
    the prefill's first token and, row by row, the decode step."""
    if temperature == 0.0:
        return sample_logits(logit, None, 0.0, top_k)
    g = torch.Generator(device=logit.device)
    g.manual_seed(request_position_seed(base_seed, seed, position))
    return sample_logits(logit, g, temperature, top_k)


def sample_logits_per_slot(logit, base_seed: int, seeds, positions,
                           temperature: float, top_k: Optional[int] = None):
    """Row i of the (S, V) logits samples under its own (seeds[i],
    positions[i]) stream; greedy short-circuits to one argmax."""
    if temperature == 0.0:
        return sample_logits(logit, None, 0.0, top_k)
    return torch.cat([
        sample_logits_at(logit[i:i + 1], base_seed, int(seeds[i]),
                         int(positions[i]), temperature, top_k)
        for i in range(logit.shape[0])])
