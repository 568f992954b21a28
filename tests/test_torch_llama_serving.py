# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's ServingEngine on `LlamaModel` against the JAX package's, on
the CPU.

Both engines serve the same weights (the JAX package's tiny Llama test
config, block_size 64 as its serving tests take it, at group 2 — 4 query
heads over 2 kv heads — and at group 3 — 6 over 2, n_embd 48; f32).
Pinned here, at both groups:

- a staggered greedy trace with a preemption: tokens, preemptions, the
  free list and refcounts equal to the JAX engine's (`paged_kernel=
  "off"`: its XLA path), plain, under speculative decoding ("ngram" and
  "model:self", spec_k 3) and over an int8 pool;
- the shared-prefix mix with the prefix cache on: tokens, aliased blocks
  and per-tick refcounts equal to JAX's;
- the first decode tick's logits within 1e-4 of JAX's;
- the prefill's post-RoPE K/V, written into int8 pools by the port's
  writer and by JAX's, byte for byte equal (codes and scales);
- the decode step's RoPE, tables made once a tick and q, k rotated in
  one pass, bit for bit `rope_at` on each.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.models import llama as JL
from tiny_deepspeed_tpu.serving import ServeConfig as JaxServeConfig
from tiny_deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from tiny_deepspeed_tpu.serving import pool as jpool
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import llama as TL
from tiny_deepspeed_tpu_torch.serving import pool as tpool

VOCAB = 128
_WIDTHS = {"g2": dict(n_head=4, n_kv_head=2, n_embd=32),
           "g3": dict(n_head=6, n_kv_head=2, n_embd=48)}


@pytest.fixture(scope="module", params=list(_WIDTHS))
def models(request):
    kw = dict(block_size=64, vocab_size=VOCAB, n_layer=2,
              **_WIDTHS[request.param])
    jm = JL.LlamaModel(JL.LlamaConfig(compute_dtype=jnp.float32, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.LlamaModel(TL.LlamaConfig(compute_dtype=torch.float32, **kw),
                      device="cpu")
    pm.load_state_dict(T.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    return jm, jp, pm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).tolist()


def _staggered(eng):
    """Two requests, three ticks, two more; drain, checking the pool's
    accounting every tick."""
    p = [_prompt(s, n) for s, n in ((1, 10), (2, 17), (3, 9), (4, 23))]
    hs = [eng.submit(p[0], 14), eng.submit(p[1], 12)]

    def tick():
        eng.tick()
        used = sum(len(t) for t in eng.active_block_tables().values())
        assert used == eng.pool.blocks_in_use

    for _ in range(3):
        tick()
    hs += [eng.submit(p[2], 14), eng.submit(p[3], 10)]
    for _ in range(500):
        if not (eng.queue_depth or eng.n_active):
            break
        tick()
    return hs


# a 6-block pool at 8 tokens a block cannot hold three of these at once
_TIGHT = dict(max_active=3, num_blocks=6, block_tokens=8, max_seq_tokens=64)


def _jax(models, **kw):
    jm, jp, _ = models
    return JaxServingEngine(jm, jp, JaxServeConfig(paged_kernel="off", **kw))


def _port(models, **kw):
    return T.ServingEngine(models[2], T.ServeConfig(**kw), device="cpu")


@pytest.mark.parametrize("knobs", [
    {}, dict(spec_draft="ngram", spec_k=3),
    dict(spec_draft="model:self", spec_k=3), dict(quant="int8")],
    ids=["plain", "ngram", "model_self", "int8"])
def test_staggered_trace_matches_jax(models, knobs):
    kw = dict(_TIGHT, **knobs)
    jh = _staggered(_jax(models, **kw))
    peng = _port(models, **kw)
    ph = _staggered(peng)
    assert [h.status for h in ph] == ["ok"] * 4
    assert sum(h.preemptions for h in ph) >= 1, "pool too roomy"
    assert [h.tokens for h in ph] == [h.tokens for h in jh]
    assert [h.preemptions for h in ph] == [h.preemptions for h in jh]
    if "spec_draft" in knobs:
        assert [(h.spec_proposed, h.spec_accepted) for h in ph] == \
            [(h.spec_proposed, h.spec_accepted) for h in jh]
    assert peng.pool.ref_counts() == {}


def test_prefix_cache_matches_jax(models):
    kw = dict(max_active=2, num_blocks=8, block_tokens=8, max_seq_tokens=64,
              prefix_cache=True)
    sp = _prompt(100, 16)  # a 2-block shared prefix
    specs = [(sp, 6), (sp + _prompt(1, 4), 10), (sp + _prompt(2, 4), 10),
             (sp + _prompt(3, 9), 12)]
    out = []
    for eng in (_jax(models, **kw), _port(models, **kw)):
        reqs = [eng.submit(p, n) for p, n in specs]
        trace = []
        for _ in range(400):
            if not (eng.queue_depth or eng.n_active):
                break
            eng.tick()
            holders = Counter(b for t in eng.active_block_tables().values()
                              for b in t)
            holders.update(eng._prefix.blocks())
            assert dict(holders) == eng.pool.ref_counts()
            trace.append(eng.pool.ref_counts())
        out.append((reqs, trace, eng.prefix_stats()))
    (jr, jt, jst), (pr, pt, pst) = out
    assert [r.status for r in pr] == ["ok"] * 4
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    assert [r.prefix_blocks for r in pr] == [r.prefix_blocks for r in jr]
    assert pt == jt
    assert pst["blocks_aliased"] == jst["blocks_aliased"] >= 3


def test_decode_logits_match_jax(models):
    kw = dict(max_active=2, num_blocks=8, block_tokens=8)
    engs = [_jax(models, **kw), _port(models, **kw)]
    for eng in engs:
        eng.submit(_prompt(2, 17), 5)
        eng.tick()
        eng.tick()
    np.testing.assert_allclose(engs[1].last_logits.numpy(),
                               np.asarray(engs[0].last_logits),
                               atol=1e-4, rtol=1e-4)


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return tpool._raw(t).contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_prefill_kv_writes_int8_pools_as_jax(models, mode):
    """The prefill hook's per-layer post-RoPE K/V (the rotation keeps
    the (B, T, KVH, Dh) layout of K's product; V is a view of its own),
    through the port's scatter and through JAX's: the same bytes in
    blocks 1.. (codes and scales)."""
    pm = models[2]
    c = pm.config
    idx = torch.tensor([_prompt(7, 16)])
    stacked = pm.stacked_compute_params()
    x = pm.embed(idx)
    ks, vs = [], []
    with torch.no_grad():
        for l in range(c.n_layer):
            x, (k, v) = pm._block(x, pm._layer(stacked, l), return_kv=True)
            ks.append(k)
            vs.append(v)
    assert ks[0].shape == (1, c.kv_heads, 16, c.head_dim)
    assert ks[0].stride()[1:] == (c.head_dim, c.kv_heads * c.head_dim, 1)
    geo = dict(n_layer=c.n_layer, kv_heads=c.kv_heads, head_dim=c.head_dim,
               num_blocks=6, block_tokens=8, quant=mode)
    tp = tpool.PagedKVPool(dtype=torch.float32, device="cpu", **geo)
    jp = jpool.PagedKVPool(dtype=jnp.float32, **geo)
    tpool.paged_scatter(tp.view, ks, vs, torch.tensor([3, 5]), 8)
    jv = jpool.paged_scatter(
        jp.view, jnp.asarray(torch.stack(ks).numpy()),
        jnp.asarray(torch.stack(vs).numpy()), jnp.asarray([3, 5]), 8)
    for got, want in zip(tp.view, jv):
        np.testing.assert_array_equal(_bytes(got)[1:], _bytes(want)[1:])


def test_decode_tables_once_a_tick_equal_per_layer(models):
    """`paged_decode` makes the rotation tables once a tick and rotates q
    and k in one pass: the bits of `rope_at` on each, as a layer making
    its own tables would get them."""
    pm = models[2]
    c = pm.config
    pos = torch.tensor([11, 6, 0])
    rot = pm._rot(pos[:, None])
    h = torch.randn(3, 1, c.n_embd, generator=torch.Generator()
                    .manual_seed(0))
    q, k, _ = pm._qkv(h, pm._layer(pm.stacked_compute_params(), 0))
    q1, k1 = pm._rope_qk(q, k, rot)
    assert torch.equal(q1, TL.rope_at(q, pos, c.rope_theta))
    assert torch.equal(k1, TL.rope_at(k, pos, c.rope_theta))
