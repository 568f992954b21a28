# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""`GPT2Model.generate` of the PyTorch port against the JAX package's, on
the CPU, for every family.

Each model pair shares the JAX package's seeded weights (crossed through
numpy): the `tiny` GPT-2, `llama-tiny` (group 2: 4 query heads over 2 kv
heads) and a group-3 Llama (6 over 2, n_embd 48), and `moe-tiny` under
both dispatches — all f32.  Prompts of 2 rows x 13 tokens (seeded numpy)
and 12 new tokens cross a 16-token block of the private pool.  Pinned:

- greedy tokens identical to JAX's `generate`, cached (at cache_dtype
  f32 and bf16) and uncached;
- the prefill's and the first decode step's logits within 1e-5 of JAX's
  `_prefill` + `_embed_decode` / `_decode_blocks` / `head`;
- MoE at B = 4, k = 2, E = 4: a decode step whose choices overflow the
  training formula's capacity (2) decodes as JAX's drop-free S*k, under
  either dispatch; the serving engine still refuses MoE;
- the contract: N = 0 and N = 1, the block_size and the generator
  `ValueError`s, int8 caches refused;
- sampling: one generator seed gives the same tokens twice, top_k = 1 is
  greedy, every sampled token lies in its row's top k (the bits are not
  JAX's: models/sampling.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.models import ALL_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models import build_model as jax_build
import tiny_deepspeed_tpu_torch as T

B, T0, N = 2, 13, 12
FAMILIES = {
    "gpt2": ("tiny", {}),
    "llama-g2": ("llama-tiny", {}),
    "llama-g3": ("llama-tiny", dict(n_head=6, n_kv_head=2, n_embd=48)),
    "moe-einsum": ("moe-tiny", {}),
    "moe-sort": ("moe-tiny", dict(moe_dispatch="sort")),
}
LOGIT_TOL = dict(rtol=0, atol=1e-5)


def _pair(family, **extra):
    """(jax model, jax params, port model) with the same weights."""
    name, over = FAMILIES[family]
    jm = jax_build(dataclasses.replace(JAX_PRESETS[name], **over, **extra))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.build_model(dataclasses.replace(T.ALL_PRESETS[name], **over,
                                           **extra), device="cpu")
    pm.load_state_dict(T.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    return jm, jp, pm


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    return request.param


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(family, cache_dtype=None):
        key = (family, cache_dtype)
        if key not in cache:
            extra = {} if cache_dtype is None else dict(
                cache_dtype=cache_dtype)
            cache[key] = _pair(family, **extra)
        return cache[key]
    return get


def _prompt(b=B, t0=T0, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t0))


@pytest.mark.parametrize("mode", ["cached-f32", "cached-bf16", "uncached"])
def test_greedy_tokens_match_jax(family, pairs, mode):
    cache_dtype = "bf16" if mode == "cached-bf16" else None
    jm, jp, pm = pairs(family, cache_dtype)
    idx = _prompt()
    use_cache = mode != "uncached"
    want = np.asarray(jm.generate(jp, jnp.asarray(idx), N, temperature=0.0,
                                  use_cache=use_cache))
    got = pm.generate(torch.from_numpy(idx), N, temperature=0.0,
                      use_cache=use_cache)
    assert got.shape == (B, T0 + N) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_first_decode_step_logits_match_jax(family, pairs, cache_dtype):
    """The prefill's logits and the first decode step's, over the private
    pool, against JAX's dense cache."""
    jm, jp, pm = pairs(family, None if cache_dtype == "f32" else "bf16")
    idx = _prompt()
    total = T0 + N
    jl0, ks, vs = jm._prefill(jp, jnp.asarray(idx), total)
    nxt = jnp.argmax(jl0, axis=-1).astype(jnp.int32)
    jx = jm._embed_decode(jp, nxt, T0)
    jx, _, _ = jm._decode_blocks(jm.stacked_compute_params(jp), jx, ks, vs,
                                 T0)
    jl1 = jm.head(jp, jx)[:, 0]

    cache = pm._gen_cache(B, total)
    stacked, hp = pm.stacked_compute_params(), pm.head_compute_params()
    with torch.no_grad():
        l0 = pm._prefill(torch.from_numpy(idx), cache, stacked, hp)
        l1 = pm._decode_step(torch.from_numpy(np.array(nxt)).long(), T0,
                             cache, stacked, hp)
    np.testing.assert_allclose(l0.numpy(), np.asarray(jl0), **LOGIT_TOL)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), **LOGIT_TOL)
    # the pool rests in the cache dtype
    assert cache.view.k.dtype == (torch.float32 if cache_dtype == "f32"
                                  else torch.bfloat16)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_decode_is_drop_free_where_training_capacity_drops(dispatch):
    """B = 4 rows, k = 2, E = 4: the training formula gives 2 slots an
    expert at S = 4; the decode routes with S*k = 8, as JAX's does."""
    fam = "moe-einsum" if dispatch == "einsum" else "moe-sort"
    jm, jp, pm = _pair(fam)
    cfg = pm.config
    b = 4
    assert pm._capacity(b) == 2
    caps, loads = [], []
    route_cap, router = pm._capacity, pm._router

    def capacity(tokens, capacity=None):
        caps.append((tokens, capacity))
        return route_cap(tokens, capacity)

    def router_rec(x, w):
        out = router(x, w)
        if x.shape[0] == b:  # a decode step's panel
            loads.append(int(torch.bincount(out[1].reshape(-1),
                                            minlength=cfg.n_expert).max()))
        return out

    pm._capacity, pm._router = capacity, router_rec
    idx = _prompt(b=b, seed=4)
    got = pm.generate(torch.from_numpy(idx), N, temperature=0.0)
    want = np.asarray(jm.generate(jp, jnp.asarray(idx), N, temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), want)
    decode = [c for t, c in caps if t == b]
    assert decode and all(c == b * cfg.expert_top_k for c in decode)
    # some decode step routed more choices to an expert than the training
    # formula's 2 slots hold
    assert max(loads) > 2
    with pytest.raises(ValueError, match="paged decode"):
        T.ServingEngine(pm, T.ServeConfig(max_active=2, num_blocks=8,
                                          block_tokens=8), device="cpu")


def test_contract(pairs):
    jm, jp, pm = pairs("gpt2")
    idx = torch.from_numpy(_prompt())
    for use_cache in (True, False):
        out = pm.generate(idx, 0, temperature=0.0, use_cache=use_cache)
        assert torch.equal(out, idx)
        one = pm.generate(idx, 1, temperature=0.0, use_cache=use_cache)
        np.testing.assert_array_equal(one.numpy(), np.asarray(
            jm.generate(jp, jnp.asarray(idx.numpy()), 1, temperature=0.0,
                        use_cache=use_cache)))
    bs = pm.config.block_size
    with pytest.raises(ValueError, match="block_size"):
        pm.generate(idx, bs - T0 + 1, temperature=0.0)
    with pytest.raises(ValueError, match="explicit generator"):
        pm.generate(idx, 4, temperature=0.7)
    for cd in ("int8", torch.int8):
        q = T.GPT2Model(dataclasses.replace(pm.config, cache_dtype=cd),
                        device="cpu")
        with pytest.raises(ValueError):
            q.generate(idx, 4, temperature=0.0)


def test_sampling(pairs):
    _, _, pm = pairs("gpt2")
    idx = torch.from_numpy(_prompt())

    def sample(seed, **kw):
        return pm.generate(idx, N, generator=torch.Generator().manual_seed(
            seed), **kw)

    a, b = sample(7, temperature=1.0), sample(7, temperature=1.0)
    assert torch.equal(a, b)
    assert not torch.equal(a, sample(8, temperature=1.0))
    greedy = pm.generate(idx, N, temperature=0.0)
    assert torch.equal(sample(7, temperature=1.3, top_k=1), greedy)
    k = 5
    out = sample(3, temperature=2.0, top_k=k)
    with torch.no_grad():
        for i in range(T0, T0 + N):
            logit = pm.apply(out[:, :i])[:, 0]
            top = torch.topk(logit, k, dim=-1).indices
            assert bool((top == out[:, i:i + 1]).any(dim=-1).all()), i
