# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The PyTorch port's ServingEngine against the JAX package's.

Both engines serve the same staggered greedy trace on the same `tiny`
(f32) weights: requests admitted at different ticks, a pool small enough
to force a preemption.  The port must reproduce every request's token
stream exactly, preempt the same requests, and end with the same pool
accounting (free list order and refcounts).  Also pinned: temperature>0
resume determinism, quarantine and warm restart, deadline and watermark
shedding, eos, the per-tick accounting invariant, and the refused knobs
(speculative decoding, the prefix cache and quantized pools have their
own files: test_torch_spec.py, test_torch_prefix.py, test_torch_quant.py).
"""

import jax
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
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


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, VOCAB, n).tolist() for n in (10, 17, 9, 23)]


def _staggered(eng):
    """Two requests, three ticks, two more; drain.  Returns the handles."""
    p = _prompts()
    hs = [eng.submit(p[0], 14), eng.submit(p[1], 12)]
    for _ in range(3):
        eng.tick()
    hs += [eng.submit(p[2], 14), eng.submit(p[3], 10)]
    eng.drain(max_ticks=500)
    return hs


# a 7-block pool at 8 tokens/block cannot hold three of these at once
_TIGHT = dict(max_active=3, num_blocks=7, block_tokens=8, max_seq_tokens=64)


def _port(pm, **kw):
    return T.ServingEngine(pm, T.ServeConfig(**kw), device="cpu")


def _assert_accounting(eng):
    used = sum(len(t) for t in eng.active_block_tables().values())
    assert used == eng.pool.blocks_in_use


class TestJaxParity:
    def test_staggered_trace_with_preemption_matches_jax(self, models):
        jm, jp, pm = models
        jeng = JaxServingEngine(jm, jp, JaxServeConfig(paged_kernel="off",
                                                       **_TIGHT))
        peng = _port(pm, **_TIGHT)
        jh, ph = _staggered(jeng), _staggered(peng)
        assert [h.status for h in ph] == ["ok"] * 4
        assert sum(h.preemptions for h in ph) >= 1, "pool too roomy"
        assert [h.tokens for h in ph] == [h.tokens for h in jh]
        assert [h.preemptions for h in ph] == [h.preemptions for h in jh]
        assert peng.pool._free == jeng.pool._free
        assert peng.pool.ref_counts() == jeng.pool.ref_counts() == {}

    def test_decode_logits_match_jax(self, models):
        """One admission + one decode tick: the plain decode step's
        (S, V) logits agree with the JAX engine's within 1e-4."""
        jm, jp, pm = models
        kw = dict(max_active=2, num_blocks=8, block_tokens=8)
        jeng = JaxServingEngine(jm, jp, JaxServeConfig(paged_kernel="off",
                                                       **kw))
        peng = _port(pm, **kw)
        for eng in (jeng, peng):
            eng.submit(_prompts()[1], 5)
            eng.tick()
        np.testing.assert_allclose(peng.last_logits.numpy()[0],
                                   np.asarray(jeng.last_logits)[0],
                                   atol=1e-4, rtol=1e-4)


class TestScheduler:
    def test_accounting_exact_every_tick(self, models):
        eng = _port(models[2], **_TIGHT)
        for p in _prompts():
            eng.submit(p, 12)
        while eng.queue_depth or eng.n_active:
            eng.tick()
            _assert_accounting(eng)
        assert eng.pool.blocks_in_use == 0

    def test_nongreedy_resume_is_deterministic(self, models):
        outs, pre = [], []
        for blocks in (5, 24):
            eng = _port(models[2], max_active=3, num_blocks=blocks,
                        block_tokens=8, temperature=1.0, top_k=16)
            hs = [eng.submit(_prompts()[0][:10], 14, seed=100 + s)
                  for s in range(3)]
            eng.drain(max_ticks=2000)
            outs.append([h.tokens for h in hs])
            pre.append(sum(h.preemptions for h in hs))
        assert pre[0] >= 1 and pre[1] == 0
        assert outs[0] == outs[1]

    def test_quarantine_keeps_the_rest_serving(self, models):
        ref = _staggered(_port(models[2], max_active=4, num_blocks=32,
                               block_tokens=8))
        eng = _port(models[2], max_active=4, num_blocks=32, block_tokens=8)
        p = _prompts()
        hs = [eng.submit(p[0], 14), eng.submit(p[1], 12)]
        eng.tick()
        eng.poison_slot(0)
        for _ in range(2):
            eng.tick()
        hs += [eng.submit(p[2], 14), eng.submit(p[3], 10)]
        eng.drain(max_ticks=500)
        assert hs[0].status == "failed"
        assert hs[0].finish_reason == "nonfinite_logits"
        assert [h.tokens for h in hs[1:]] == [h.tokens for h in ref[1:]]
        assert eng.pool.blocks_in_use == 0

    def test_warm_restart_continues_token_exact(self, models):
        ref = _staggered(_port(models[2], max_active=4, num_blocks=32,
                               block_tokens=8))
        eng = _port(models[2], max_active=4, num_blocks=32, block_tokens=8,
                    guard_k_restart=1)
        p = _prompts()
        hs = [eng.submit(p[0], 14), eng.submit(p[1], 12)]
        eng.tick()
        eng.poison_slot(1)
        for _ in range(2):
            eng.tick()
        hs += [eng.submit(p[2], 14), eng.submit(p[3], 10)]
        eng.drain(max_ticks=500)
        assert eng.restarts == 1
        assert hs[1].status == "failed"
        assert hs[0].preemptions == 1  # re-queued by the restart
        for i in (0, 2, 3):
            assert hs[i].status == "ok" and hs[i].tokens == ref[i].tokens

    def test_shedding_and_expiry(self, models):
        eng = _port(models[2], max_active=1, num_blocks=16, block_tokens=8,
                    max_queue=1)
        p = _prompts()
        a = eng.submit(p[0], 4)
        b = eng.submit(p[1], 4)
        assert a.status is None and b.status == "shed"
        assert b.finish_reason == "shed:queue_watermark"
        full = _port(models[2], max_active=1, num_blocks=16,
                     block_tokens=8, shed_pool_util=0.0)
        full.submit(p[0], 4)  # a backlog at a "full" pool: the next sheds
        assert full.submit(p[1], 4).finish_reason == "shed:pool_watermark"
        eng2 = _port(models[2], max_active=1, num_blocks=16, block_tokens=8)
        late = eng2.submit(p[2], 4, deadline_s=0.0)
        eng2.tick()
        assert late.status == "shed"
        assert late.finish_reason == "shed:deadline_overdue"
        eng3 = _port(models[2], max_active=1, num_blocks=16, block_tokens=8)
        slow = eng3.submit(p[0], 50, deadline_s=60.0)
        eng3.tick()
        slow.deadline_s = 0.0  # blow the deadline while active
        eng3.tick()
        assert slow.status == "expired" and eng3.pool.blocks_in_use == 0

    def test_eos_stops_and_keeps_the_token(self, models):
        ref = _port(models[2], max_active=1, num_blocks=16,
                    block_tokens=8)
        r = ref.submit(_prompts()[0], 8)
        ref.drain()
        eos = r.tokens[3]
        eng = _port(models[2], max_active=1, num_blocks=16, block_tokens=8,
                    eos_id=eos)
        e = eng.submit(_prompts()[0], 8)
        eng.drain()
        cut = r.tokens.index(eos) + 1
        assert e.tokens == r.tokens[:cut] and e.finish_reason == "eos"

    def test_bucket_and_operands(self, models):
        eng = _port(models[2], max_active=1, num_blocks=16, block_tokens=8)
        assert [eng._bucket(p) for p in (1, 8, 9, 17, 33, 200)] == \
            [8, 8, 16, 32, 64, 256]
        padded, ids = eng._prefill_operands(list(range(1, 17)), [3, 4, 5])
        assert padded.shape == (1, 16) and ids.tolist() == [3, 4]

    def test_malformed_requests_raise(self, models):
        eng = _port(models[2], max_active=1, num_blocks=4, block_tokens=8,
                    max_seq_tokens=40)
        with pytest.raises(ValueError, match="non-empty"):
            eng.submit([], 3)
        with pytest.raises(ValueError, match="max_seq_tokens"):
            eng.submit([1] * 30, 20)
        with pytest.raises(ValueError, match="blocks"):
            eng.submit([1] * 30, 6)


class TestPoolAccounting:
    def test_refcounts_and_lifo_match_jax(self):
        """The same alloc/share/free sequence leaves the JAX pool and the
        port's pool with the same free list and refcounts."""
        from tiny_deepspeed_tpu.serving.pool import PagedKVPool as JaxPool
        kw = dict(n_layer=1, kv_heads=1, head_dim=8, num_blocks=6,
                  block_tokens=4)
        jp = JaxPool(dtype=np.float32, **kw)
        tp = T.serving.PagedKVPool(dtype=torch.float32, device="cpu", **kw)
        for pool in (jp, tp):
            a = pool.alloc(3)
            b = pool.alloc(2)
            pool.share(a[:2])
            pool.free_blocks(a)
            pool.free_blocks(b[::-1])
            assert pool.alloc(9) is None
        assert tp._free == jp._free and tp.ref_counts() == jp.ref_counts()
        assert tp.blocks_in_use == jp.blocks_in_use == 2
        with pytest.raises(ValueError, match="double free"):
            tp.free_blocks([a[2]])
        with pytest.raises(ValueError, match="invalid"):
            tp.free_blocks([0])
        with pytest.raises(ValueError, match="not allocated"):
            tp.share([a[2]])
        assert tp.view.k.shape == (7, 4, 1, 1, 8)


class TestRefused:
    # spec: a bad spec_k; prefix: the cache together with spec (JAX
    # refuses it too); quant: a mode the pool has no codec for; drafter:
    # an unknown drafter
    @pytest.mark.parametrize("knob", [
        dict(spec_draft="ngram", spec_k=0),
        dict(prefix_cache=True, spec_draft="ngram"),
        dict(tenants={}), dict(quant="int4"), dict(flight_ticks=64),
        dict(block_tokens=7), dict(max_active=0),
        dict(spec_draft="medusa"),
    ], ids=["spec", "prefix", "tenants", "quant", "flight", "bt", "slots",
            "drafter"])
    def test_config_refused(self, models, knob):
        with pytest.raises(ValueError):
            _port(models[2], **knob)

    @pytest.mark.parametrize("kw", ["telemetry", "logger", "journal"])
    def test_attachments_refused(self, models, kw):
        with pytest.raises(ValueError, match="not ported"):
            T.ServingEngine(models[2], T.ServeConfig(), device="cpu",
                            **{kw: object()})

    def test_methods_refused(self, models):
        eng = _port(models[2])
        for call in (eng.recover, eng.export_request, eng.import_request,
                     lambda: eng.attach_slo(None),
                     lambda: eng.attach_live(None)):
            with pytest.raises(ValueError, match="not ported"):
                call()

    def test_pool_refuses_quant(self):
        """A quant mode with no codec is refused (int8 and fp8 exist)."""
        with pytest.raises(ValueError, match="quant must be one of"):
            T.serving.PagedKVPool(n_layer=1, kv_heads=1, head_dim=8,
                                  num_blocks=2, block_tokens=4,
                                  dtype=torch.float32, quant="int4",
                                  device="cpu")
