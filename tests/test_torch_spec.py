# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Speculative decoding and the quantized / span paged attention of the
port against the JAX package, on the CPU.

  * the plain versions of paged attention's int8/fp8 decode variant and
    span-verify variant (what the card kernels are held to) against the
    JAX Pallas kernel in interpret mode and against the JAX XLA path
    (`paged_panel` + `_decode_attention` / `_span_attention`), within
    2e-5 in f32: a pos0 = 0 slot, a block-boundary pos0, int8 and fp8
    pools, hq = 4 over kvh = 2;
  * `spec_accept_per_slot`, greedy, equal to JAX's; the temperature > 0
    accept-or-residual rule's marginal equal to p (chi-square);
  * `NgramDrafter` proposals equal to JAX's;
  * the ngram and model:self engines (and int8 / fp8 pools under spec)
    against the JAX engine (`paged_kernel="off"`) on a staggered trace
    with preemption: tokens, preemptions, spec counters, free list and
    refcounts;
  * temperature > 0 determinism (tight pool against roomy pool), eos in
    the middle of a span, warm restart, and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.paged_attn_pallas as JPA
from tiny_deepspeed_tpu.models import sampling as jsampling
from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from tiny_deepspeed_tpu.serving import ServeConfig as JaxServeConfig
from tiny_deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from tiny_deepspeed_tpu.serving import pool as jpool
from tiny_deepspeed_tpu.serving.drafter import NgramDrafter as JaxNgram
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import sampling
from tiny_deepspeed_tpu_torch.ops import paged_attn
from tiny_deepspeed_tpu_torch.serving import pool as tpool
from tiny_deepspeed_tpu_torch.serving.drafter import NgramDrafter

VOCAB = 512
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JPA, "INTERPRET", True)


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2(JAX_PRESETS["tiny"])
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    pm.load_state_dict(T.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    return jm, jp, pm


# -- the plain versions of kernels 9b and 9c ---------------------------------

_TABLES = [[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]]


def _views(quant, kvh=2, dh=16, L=2, bt=8, blocks=16):
    """The same random pool on both sides (codes and scales through the
    JAX codec when quantized)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    shape = (blocks + 1, bt, L, kvh, dh)
    raw_k = jax.random.normal(k1, shape, jnp.float32)
    raw_v = jax.random.normal(k2, shape, jnp.float32)
    if quant:
        qk, sk = jpool._quant_vectors(raw_k, quant)
        qv, sv = jpool._quant_vectors(raw_v, quant)
        jview = jpool.KVPoolView(qk, qv, sk, sv)
    else:
        jview = jpool.KVPoolView(raw_k, raw_v, None, None)

    def t(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.itemsize == 1 and a.dtype != np.int8:  # e4m3 bytes
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(a.copy())

    return jview, tpool.KVPoolView(*(t(a) for a in jview))


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("hq", [2, 4])
def test_quant_decode_plain_matches_pallas_and_xla(models, quant, hq):
    jm = models[0]
    jview, tview = _views(quant)
    tables = np.asarray(_TABLES, np.int32)
    pos = np.asarray([25, 9, 0], np.int32)  # mid / partial / first token
    q = np.random.default_rng(hq).standard_normal((3, hq, 1, 16)).astype(
        np.float32)
    jpage = jpool.page_ref(jnp.asarray(tables), jnp.asarray(pos), 8)
    tpage = tpool.page_ref(torch.from_numpy(tables), torch.from_numpy(pos), 8)
    for layer in range(2):
        got = paged_attn.paged_attention(torch.from_numpy(q), tview, tpage,
                                         layer).numpy()
        ref = JPA.paged_attention(jnp.asarray(q), jview, jpage, layer)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
        ck, cv = jpool.paged_panel(jview, layer, jpage, jnp.float32)
        xla = jm._decode_attention(jnp.asarray(q), ck, cv, jpage.pos)
        np.testing.assert_allclose(got, np.asarray(xla), **TOL)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("hq,k1", [(2, 4), (4, 3)])
def test_span_plain_matches_pallas_and_xla(models, quant, hq, k1):
    """pos0 = 0 (the pool gives nothing, span key 0 always exists), a
    mid-block pos0 and a block-boundary pos0."""
    jm = models[0]
    jview, tview = _views(quant)
    rng = np.random.default_rng(10 * hq + k1)
    tables = np.asarray(_TABLES, np.int32)
    pos0 = np.asarray([21, 16, 0], np.int32)
    q = rng.standard_normal((3, hq, k1, 16)).astype(np.float32)
    sk, sv = (rng.standard_normal((3, 2, k1, 16)).astype(np.float32)
              for _ in range(2))
    jpage = jpool.page_ref(jnp.asarray(tables), jnp.asarray(pos0), 8)
    tpage = tpool.page_ref(torch.from_numpy(tables), torch.from_numpy(pos0),
                           8)
    for layer in range(2):
        got = paged_attn.paged_attention(
            torch.from_numpy(q), tview, tpage, layer,
            span_kv=(torch.from_numpy(sk), torch.from_numpy(sv))).numpy()
        ref = JPA.paged_attention(jnp.asarray(q), jview, jpage, layer,
                                  span_kv=(jnp.asarray(sk), jnp.asarray(sv)))
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
        ck, cv = jpool.paged_panel(jview, layer, jpage, jnp.float32)
        xla = jm._span_attention(jnp.asarray(q), ck, cv, jnp.asarray(sk),
                                 jnp.asarray(sv), jpage.pos)
        np.testing.assert_allclose(got, np.asarray(xla), **TOL)
        assert np.isfinite(got).all()


# -- sampling and drafting -----------------------------------------------------

def test_spec_accept_greedy_equals_jax():
    rng = np.random.default_rng(3)
    s, k, v = 5, 4, 32
    logits = rng.standard_normal((s, k + 1, v)).astype(np.float32)
    logits[0, 2, 7] = logits[0, 2, 9] = 50.0  # a tie: first index wins
    tgt = logits.argmax(-1)
    span = np.zeros((s, k + 1), np.int32)
    span[:, 0] = rng.integers(0, v, s)
    span[:, 1:] = tgt[:, :k]
    span[1, 3] = (tgt[1, 2] + 1) % v   # rejects at offset 2
    span[2, 1] = (tgt[2, 0] + 1) % v   # rejects at once
    extra = rng.integers(0, v, s).astype(np.int32)
    seeds = np.arange(s, dtype=np.int32)
    nprod = np.full((s,), 3, np.int32)
    ja, jf = jsampling.spec_accept_per_slot(
        jnp.asarray(logits), jnp.asarray(span), jnp.asarray(extra),
        jax.random.PRNGKey(0), jnp.asarray(seeds), jnp.asarray(nprod), 0.0)
    ta, tf = sampling.spec_accept_per_slot(
        torch.from_numpy(logits), torch.from_numpy(span), extra, 0, seeds,
        nprod, 0.0)
    assert ta.tolist() == np.asarray(ja).tolist() == [4, 2, 0, 4, 4]
    assert tf.tolist() == np.asarray(jf).tolist()


def test_accept_or_residual_marginal_is_p():
    """Over many positions' streams the committed token's distribution is
    p whatever the proposal (chi-square, 7 dof, p-value > 1e-3)."""
    p = torch.tensor([0.3, 0.2, 0.15, 0.1, 0.1, 0.08, 0.05, 0.02])
    n = 4000
    counts = np.zeros(8)
    for pos in range(n):
        seed = sampling.request_position_seed(0, 11, pos)
        counts[sampling._accept_or_residual(p, pos % 3, seed)] += 1
    expected = p.numpy() * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts.tolist())  # chi2(7) at 1e-3


def test_spec_prefill_commit_greedy_and_sampled():
    logit = torch.tensor([[0.1, 2.0, -1.0, 0.5]])
    assert sampling.spec_prefill_commit(logit, 3, 0, 1, 0, 0.0).tolist() \
        == [1]
    a = sampling.spec_prefill_commit(logit, 3, 0, 1, 5, 0.7)
    b = sampling.spec_prefill_commit(logit, 3, 0, 1, 5, 0.7)
    assert a.tolist() == b.tolist() and 0 <= int(a) < 4


@pytest.mark.parametrize("ctx", [
    [5, 9, 2] * 4 + [5, 9], [1, 2, 3, 4, 5],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 1, 4], [7], list(range(40)) * 2])
def test_ngram_proposals_equal_jax(ctx):
    for k in (1, 4):
        assert NgramDrafter(k).propose_one(ctx) == \
            JaxNgram(k).propose_one(ctx)
        assert NgramDrafter(k).on_admit(0, ctx) == JaxNgram(k).on_admit(0, ctx)


# -- engines against the JAX engine ----------------------------------------------

def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, VOCAB, n).tolist() for n in (10, 17, 9, 23)]


def _staggered(eng, check=None):
    p = _prompts()
    hs = [eng.submit(p[0], 14), eng.submit(p[1], 12)]
    for _ in range(3):
        eng.tick()
        if check:
            check(eng)
    hs += [eng.submit(p[2], 14), eng.submit(p[3], 10)]
    ticks = 0
    while eng.queue_depth or eng.n_active:
        eng.tick()
        if check:
            check(eng)
        ticks += 1
        assert ticks < 500
    return hs


# a 6-block pool at 8 tokens/block preempts under spec_k=3 (the span
# horizon claims blocks early)
_TIGHT = dict(max_active=3, num_blocks=6, block_tokens=8, max_seq_tokens=64)


def _port(pm, **kw):
    return T.ServingEngine(pm, T.ServeConfig(**kw), device="cpu")


def _jax(models, **kw):
    jm, jp, _ = models
    return JaxServingEngine(jm, jp, JaxServeConfig(paged_kernel="off", **kw))


def _assert_accounting(eng):
    used = sum(len(t) for t in eng.active_block_tables().values())
    assert used == eng.pool.blocks_in_use


@pytest.mark.parametrize("draft,quant", [
    ("ngram", None), ("model:self", None), ("ngram", "int8"),
    ("model:self", "fp8")])
def test_spec_engine_matches_jax(models, draft, quant):
    kw = dict(_TIGHT, spec_draft=draft, spec_k=3, quant=quant)
    jeng, peng = _jax(models, **kw), _port(models[2], **kw)
    jh = _staggered(jeng)
    ph = _staggered(peng, _assert_accounting)
    assert [h.status for h in ph] == ["ok"] * 4
    assert sum(h.preemptions for h in jh) >= 1, "pool too roomy"
    assert [h.tokens for h in ph] == [h.tokens for h in jh]
    assert [h.preemptions for h in ph] == [h.preemptions for h in jh]
    assert [(h.spec_proposed, h.spec_accepted) for h in ph] == \
        [(h.spec_proposed, h.spec_accepted) for h in jh]
    assert (peng._spec_proposed, peng._spec_accepted, peng._spec_ticks,
            peng._spec_tokens) == (jeng._spec_proposed, jeng._spec_accepted,
                                   jeng._spec_ticks, jeng._spec_tokens)
    assert peng.pool._free == jeng.pool._free
    assert peng.pool.ref_counts() == jeng.pool.ref_counts() == {}
    assert peng.last_logits is None
    if draft == "model:self":  # the target's own proposals mostly accept
        assert peng._spec_accepted >= 0.8 * peng._spec_proposed


@pytest.mark.parametrize("draft", ["ngram", "model:tiny"])
def test_spec_tokens_equal_plain_greedy(models, draft):
    """Greedy acceptance is token equality, so any drafter — here also a
    seeded random-init preset — commits the plain engine's tokens."""
    plain = _staggered(_port(models[2], **_TIGHT))
    eng = _port(models[2], spec_draft=draft, spec_k=4, **_TIGHT)
    spec = _staggered(eng)
    assert [h.tokens for h in spec] == [h.tokens for h in plain]
    assert eng._spec_proposed > 0


@pytest.mark.parametrize("draft", ["ngram", "model:self"])
def test_temperature_resume_is_deterministic(models, draft):
    outs, pre = [], []
    for blocks in (5, 24):
        eng = _port(models[2], max_active=3, num_blocks=blocks,
                    block_tokens=8, max_seq_tokens=64, temperature=1.0,
                    top_k=16, spec_draft=draft, spec_k=3)
        hs = [eng.submit(_prompts()[0][:10], 14, seed=100 + s)
              for s in range(3)]
        eng.drain(max_ticks=2000)
        outs.append([h.tokens for h in hs])
        pre.append(sum(h.preemptions for h in hs))
    assert pre[0] >= 1 and pre[1] == 0
    assert outs[0] == outs[1]


def test_eos_truncates_mid_span(models):
    ref = _port(models[2], max_active=2, num_blocks=16, block_tokens=8)
    r = ref.submit(_prompts()[0], 12)
    ref.drain()
    eos = r.tokens[5]
    eng = _port(models[2], max_active=2, num_blocks=16, block_tokens=8,
                eos_id=eos, spec_draft="model:self", spec_k=4)
    e = eng.submit(_prompts()[0], 12)
    eng.drain(max_ticks=100)
    assert e.finish_reason == "eos"
    assert e.tokens == r.tokens[:r.tokens.index(eos) + 1]
    assert eng.pool.blocks_in_use == 0


def test_warm_restart_continues_token_exact(models):
    kw = dict(max_active=3, num_blocks=32, block_tokens=8, spec_k=3,
              spec_draft="model:self")
    ref = _staggered(_port(models[2], **kw))
    eng = _port(models[2], guard_k_restart=1, **kw)
    p = _prompts()
    hs = [eng.submit(p[0], 14), eng.submit(p[1], 12)]
    eng.tick()
    eng.poison_slot(1)
    eng.tick()
    hs += [eng.submit(p[2], 14), eng.submit(p[3], 10)]
    eng.drain(max_ticks=500)
    assert eng.restarts == 1 and hs[1].status == "failed"
    assert hs[0].preemptions == 1  # re-queued by the restart
    for i in (0, 2, 3):
        assert hs[i].status == "ok" and hs[i].tokens == ref[i].tokens
    _assert_accounting(eng)


def test_spec_refusals(models):
    pm = models[2]
    with pytest.raises(ValueError, match="spec_k"):
        _port(pm, spec_draft="ngram", spec_k=17)
    with pytest.raises(ValueError, match="vocab"):
        _port(pm, spec_draft="model:gpt2-124m")
    with pytest.raises(ValueError, match="block_size"):
        T.serving.ModelDrafter(pm, 2, max_active=2, max_seq=512,
                               block_tokens=8)
