# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The one sampling core: final-position logits -> next tokens.

Counterpart of `tiny_deepspeed_tpu/models/sampling.py`: plain sampling
and the speculative accept-or-residual rule.  Greedy decoding
(temperature 0) is argmax with the first index on ties, token-exact with
the JAX package; greedy speculative acceptance is token equality, also
exact.  For temperature > 0 each draw is a Gumbel-max over a
`torch.Generator` seeded from (engine seed, request seed, output
position) only — never from the tick, the batch or the preemption count
— so a resumed request re-samples the same tokens.  The speculative rule
draws its uniform from that stream too and its residual from a second
seed derived from it (standing in for JAX's `fold_in(key, 1)`).  None of
this reproduces JAX's random bits: the rules and their distributions
are the same, the bits are not.
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


def residual_seed(pos_seed: int) -> int:
    """The accept-or-residual rule's second stream at one position: a
    seed derived from the position's seed (JAX: fold_in(key, 1))."""
    return _mix(_mix(int(pos_seed)) ^ 1) >> 1


def _uniform(pos_seed: int) -> float:
    """u ~ U[0, 1) from the position's stream (a CPU generator: the same
    number on every device)."""
    g = torch.Generator().manual_seed(pos_seed)
    return float(torch.rand((), generator=g))


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


def _accept_or_residual(p_row, prop: int, pos_seed: int):
    """ONE position's committed token under the speculative rule (JAX
    :93): given the target's (V,) probability row, the drafter's point-
    mass proposal `prop` and the position's seed, commit `prop` iff
    u < p(prop), else draw from the renormalized residual (p with `prop`
    zeroed) under `residual_seed`.  The marginal is exactly `p_row`
    either way.  Both commit sites (`spec_prefill_commit` and the final
    token of `spec_accept_per_slot`) ride this one function, so a
    position commits the same token whichever program reaches it."""
    if _uniform(pos_seed) < float(p_row[prop]):
        return int(prop)
    r = p_row.clone()
    r[prop] = 0.0
    g = torch.Generator(device=p_row.device)
    g.manual_seed(residual_seed(pos_seed))
    u = torch.rand(r.shape, generator=g, device=r.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return int(torch.argmax(torch.log(r) - torch.log(-torch.log(u))))


def _target_probs(logit, temperature: float, top_k: Optional[int]):
    return torch.softmax(_top_k_filter(logit, top_k) / temperature, dim=-1)


def spec_prefill_commit(logit, prop: int, base_seed: int, seed: int,
                        position: int, temperature: float,
                        top_k: Optional[int] = None):
    """First-token commit of a SPECULATIVE engine's prefill (JAX :115):
    the same accept-or-residual rule the verify step applies, against
    the drafter's proposal for this position.  (1, V) logits -> (1,)
    tokens; greedy is the plain argmax."""
    if temperature == 0.0:
        return sample_logits(logit, None, 0.0, top_k)
    p = _target_probs(logit, temperature, top_k)
    tok = _accept_or_residual(
        p[0], int(prop), request_position_seed(base_seed, seed, position))
    return torch.tensor([tok], device=logit.device)


def spec_accept_per_slot(logits, span, extra, base_seed: int, seeds, nprod,
                         temperature: float, top_k: Optional[int] = None):
    """Speculative acceptance for the verify step (JAX :137, Leviathan et
    al., arXiv:2211.17192).  logits (S, K+1, V) f32: the target scored at
    every span offset; span (S, K+1) = [last committed token, d_1..d_K];
    extra (S,) the drafter's bonus-position proposal.  Returns (accepted
    (S,) in [0, K], final (S,)): each verify commits accepted + 1 tokens.

    temperature == 0 is TOKEN EQUALITY against the target argmax, so the
    committed sequence is the target's greedy one whatever the drafter
    proposed.  temperature > 0 applies at every offset the point-mass
    accept-or-residual rule: draft j commits iff u_j < p_j(d_j), u_j from
    the (seed, nprod + j) stream; the final token runs
    `_accept_or_residual` at the first rejection (or against `extra` at
    the bonus position)."""
    k = span.shape[1] - 1
    span = span.to(logits.device).long()
    if temperature == 0.0:
        tgt = torch.argmax(logits, dim=-1)  # (S, K+1), first index on ties
        match = (tgt[:, :k] == span[:, 1:]).long()
        acc = torch.cumprod(match, dim=1).sum(dim=1)
        final = torch.gather(tgt, 1, acc[:, None])[:, 0]
        return acc, final
    p = _target_probs(logits, temperature, top_k)  # (S, K+1, V)
    props = torch.cat([span[:, 1:], torch.as_tensor(
        extra, device=logits.device).long()[:, None]], dim=1)
    pd = torch.gather(p[:, :k], 2, props[:, :k, None])[..., 0].cpu()
    s_count = logits.shape[0]
    acc, final = [], []
    for i in range(s_count):
        a = 0
        while a < k and _uniform(request_position_seed(
                base_seed, int(seeds[i]), int(nprod[i]) + a)) < float(pd[i, a]):
            a += 1
        acc.append(a)
        final.append(_accept_or_residual(
            p[i, a], int(props[i, a]),
            request_position_seed(base_seed, int(seeds[i]),
                                  int(nprod[i]) + a)))
    dev = logits.device
    return torch.tensor(acc, device=dev), torch.tensor(final, device=dev)
