# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's shared-prefix cache against the JAX package's, on the CPU.

  * `PrefixCache` match / insert / evict sequences leave the same tree,
    the same free list and the same refcounts as JAX's;
  * the engine with the cache on against the JAX engine
    (`paged_kernel="off"`) on a shared-prefix choreography (a cold
    boundary-length prompt, suffix prefills over aliased blocks, a
    partial-prefix hit, a tight pool forcing tree eviction and
    preemption): tokens, `prefix_blocks`, stats, and the refcounts at
    every tick;
  * cache on against cache off: token-identical;
  * int8 and fp8 pools with the prefix cache against the JAX engine —
    the codecs are bit-equal, so the tokens are equal;
  * the composition with speculative decoding is refused, and a warm
    restart rebuilds the tree empty.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from tiny_deepspeed_tpu.serving import PagedKVPool as JaxPool
from tiny_deepspeed_tpu.serving import PrefixCache as JaxPrefixCache
from tiny_deepspeed_tpu.serving import ServeConfig as JaxServeConfig
from tiny_deepspeed_tpu.serving import ServingEngine as JaxServingEngine
import tiny_deepspeed_tpu_torch as T

VOCAB = 512


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2(JAX_PRESETS["tiny"])
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    pm.load_state_dict(T.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    return jm, jp, pm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).tolist()


def _tree_state(tree):
    """Every node as (path of block keys, block, last_hit)."""
    out = []
    stack = [((), n) for n in tree._root.children.values()]
    while stack:
        path, n = stack.pop()
        out.append((path + (n.key,), n.block, n.last_hit))
        stack.extend((path + (n.key,), c) for c in n.children.values())
    return sorted(out)


def test_prefix_tree_sequences_match_jax():
    geo = dict(n_layer=1, kv_heads=1, head_dim=4, num_blocks=10,
               block_tokens=4)
    pools = (JaxPool(dtype=jnp.float32, **geo),
             T.serving.PagedKVPool(dtype=torch.float32, device="cpu", **geo))
    trees = (JaxPrefixCache(4), T.PrefixCache(4))
    logs = []
    for pool, tree in zip(pools, trees):
        log = []
        ta = pool.alloc(3)
        log.append(tree.insert(list(range(12)), ta, pool, tick=1))
        tb = pool.alloc(2)
        log.append(tree.insert(list(range(4)) + [50] * 4, tb, pool, tick=2))
        log.append(tree.match(list(range(12)), limit=3, tick=3))
        log.append(tree.match(list(range(4)) + [50] * 8, limit=2, tick=4))
        log.append(tree.match([99] + list(range(1, 12)), limit=3, tick=5))
        pool.free_blocks(ta + tb)
        pool.share([ta[1]])
        log.append(tree.evict(pool, need=2))
        log.append(tree.reclaimable(pool))
        tree.note_admission(2, 10)
        tree.note_admission(0, 5)
        log.append((len(tree), tree.hits, tree.misses, tree.blocks_aliased,
                    tree.tokens_avoided, tree.prompt_tokens, tree.evicted))
        log.append(_tree_state(tree))
        log.append((pool._free, pool.ref_counts()))
        logs.append(log)
    assert logs[0] == logs[1]


def _jax(models, **kw):
    jm, jp, _ = models
    return JaxServingEngine(jm, jp, JaxServeConfig(paged_kernel="off", **kw))


def _port(pm, **kw):
    return T.ServingEngine(pm, T.ServeConfig(**kw), device="cpu")


def _holders(eng):
    holders = Counter(b for t in eng.active_block_tables().values()
                      for b in t)
    if eng._prefix is not None:
        holders.update(eng._prefix.blocks())
    return dict(holders)


def _choreography(eng, trace):
    """The shared-prefix mix, then a long divergent request that must
    grow by evicting tree leaves; `trace` gets the per-tick refcounts."""
    sp = _prompt(100, 16)  # a 2-block shared prefix, boundary length
    specs = [(sp, 6), (sp + _prompt(1, 4), 10), (sp + _prompt(2, 4), 10),
             (sp + _prompt(3, 9), 12), (sp[:8] + _prompt(4, 4), 8)]
    reqs = [eng.submit(p, n) for p, n in specs]

    def run():
        ticks = 0
        while eng.queue_depth or eng.n_active:
            eng.tick()
            assert _holders(eng) == eng.pool.ref_counts()
            assert (eng.pool.blocks_in_use + eng.pool.blocks_free
                    == eng.pool.num_usable)
            trace.append(eng.pool.ref_counts())
            ticks += 1
            assert ticks < 400

    run()
    reqs.append(eng.submit(_prompt(200, 24), 24))
    run()
    return reqs


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_prefix_engine_matches_jax(models, quant):
    kw = dict(max_active=2, num_blocks=8, block_tokens=8, max_seq_tokens=64,
              prefix_cache=True, quant=quant)
    jt, pt = [], []
    jr = _choreography(_jax(models, **kw), jt)
    peng = _port(models[2], **kw)
    pr = _choreography(peng, pt)
    assert [r.status for r in pr] == ["ok"] * 6
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    assert [r.prefix_blocks for r in pr] == [r.prefix_blocks for r in jr]
    assert [r.prefix_tokens for r in pr] == [r.prefix_tokens for r in jr]
    assert [r.preemptions for r in pr] == [r.preemptions for r in jr]
    assert pt == jt
    st = peng.prefix_stats()
    assert st["blocks_aliased"] >= 3 and st["tree_evictions"] >= 1
    assert st["prefill_tokens_avoided"] > 0


def test_cache_on_equals_cache_off(models):
    outs = []
    for on in (True, False):
        eng = _port(models[2], max_active=2, num_blocks=8, block_tokens=8,
                    max_seq_tokens=64, prefix_cache=on)
        outs.append([r.tokens for r in _choreography(eng, [])])
        assert (eng.prefix_stats() is None) != on
    assert outs[0] == outs[1]


def test_warm_restart_rebuilds_the_tree_empty(models):
    eng = _port(models[2], max_active=2, num_blocks=16, block_tokens=8,
                prefix_cache=True, guard_k_restart=1)
    sp = _prompt(50, 16)
    a = eng.submit(sp + _prompt(5, 4), 8)
    eng.tick()
    b = eng.submit(sp + _prompt(6, 4), 8)
    eng.tick()
    assert b.prefix_blocks == 2 and len(eng._prefix) >= 2
    eng.poison_slot(0)
    eng.tick()  # one poisoned tick trips the watchdog (k_restart=1)
    assert eng.restarts == 1 and len(eng._prefix) == 0
    assert eng.prefix_stats()["blocks_aliased"] == 2  # stats carry on
    eng.drain(max_ticks=200)
    assert a.status == "failed" and b.status == "ok"
    ref = _port(models[2], max_active=2, num_blocks=16, block_tokens=8)
    r = ref.submit(sp + _prompt(6, 4), 8)
    ref.drain()
    assert b.tokens == r.tokens
    assert _holders(eng) == eng.pool.ref_counts()


def test_spec_composition_refused(models):
    with pytest.raises(ValueError, match="prefix_cache"):
        _port(models[2], prefix_cache=True, spec_draft="ngram")
