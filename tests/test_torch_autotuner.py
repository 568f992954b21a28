# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's runtime autotuner and its dispatch sites, against the JAX
package, on the CPU.

- every case of JAX's tests/test_autotuner.py with torch counterparts of
  `fast` / `slow` / `broken`: picking and caching, the single-candidate
  shortcut, keys per shape, freezing, a broken candidate, `None` args,
  the default tuner, `choose_function`; requests recorded inside
  `deferring()` and resolved after; the cache file round trip and a
  stored name that must match a live candidate;
- the engine's life cycle: `step` records, `retune()` times, a second
  `retune()` is 0, `revert_tune()` uninstalls; the sites `retune()`
  tunes, and their (shape, dtype) signatures, equal the JAX engine's on
  the same config and batch (on the CPU both offer only the linear and
  the chunked head's sites), and five tuned steps' losses equal JAX's
  tuned engine's within 1e-4; at data 2 over gloo both ranks end with
  rank 0's winners although their own timings would disagree;
- the sites: `linear_forward`'s candidates agree (1e-6) and mode
  "candidate" offers three; the chunked head's variants against
  `softmax_cross_entropy` and JAX's `_FLX_VARIANTS` (1e-5);
  `AdamW(fused="auto")` with a tuner equals JAX's `_xla_update` (1e-6 /
  1e-7), without one takes the plain update on the CPU, and a bogus
  `fused` raises; LayerNorm's sites have one candidate and no key on the
  CPU, and their kernel candidate fails there and is counted;
- diagnostics: a failing candidate increments
  `autotune_candidate_failures`; decisions and failures are `run_meta`
  records both schema modules accept;
- `tune_e2e`, `plan_key`, `plan_hash` against JAX's, and the plan bridge
  into `comm_plan_engine_kwargs`.

JAX is imported inside the tests: the spawned gloo workers import this
module.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.autotuner import (
    RuntimeAutoTuner, deferring, get_default_tuner, plan_hash, plan_key,
    set_default_tuner, tune_e2e)
from tiny_deepspeed_tpu_torch.autotuner import runtime_tuner as RT
from tiny_deepspeed_tpu_torch.autotuner.runtime_tuner import qualname
from tiny_deepspeed_tpu_torch.ops import layernorm as LN
from tiny_deepspeed_tpu_torch.ops import linear as LIN
from tiny_deepspeed_tpu_torch.ops import matmul_fp8 as F8
from tiny_deepspeed_tpu_torch.ops import softmax_xent as SX
from tiny_deepspeed_tpu_torch.optim import adamw as AW
from test_torch_ring import spawn


def fast(x):
    return x + 1.0


def slow(x):
    y = x
    for _ in range(200):
        y = torch.sin(y)
    return y + (x + 1.0) - y


def broken(x):
    raise ValueError("unsupported shapes")


@pytest.fixture(autouse=True)
def _no_default_tuner():
    """Every test starts and ends with no port tuner installed."""
    set_default_tuner(None)
    yield
    set_default_tuner(None)


class TestRuntimeAutoTuner:
    def test_picks_and_caches(self):
        t = RuntimeAutoTuner(warmup=1, iters=2)
        x = torch.ones(256, 256)
        winner = t.choose([slow, fast], (x,))
        assert winner is fast  # 200 sines against one add
        assert len(t.cache) == 1 and t.version == 1
        assert t.choose([slow, fast], (x,)) is winner
        assert t.version == 1  # a hit times nothing

    def test_single_candidate_shortcut(self):
        t = RuntimeAutoTuner()
        assert t.choose([fast], (torch.ones(4, 4),)) is fast
        assert not t.cache

    def test_distinct_shapes_distinct_keys(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        t.choose([slow, fast], (torch.ones(64, 64),))
        t.choose([slow, fast], (torch.ones(128, 64),))
        t.choose([slow, fast], (torch.ones(128, 64, dtype=torch.float64),))
        assert len(t.cache) == 3

    def test_freeze_stops_timing(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        t.final_tune()
        assert t.frozen
        assert t.choose([slow, fast], (torch.ones(32, 32),)) is slow
        assert not t.cache

    def test_broken_candidate_survives(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        assert t.choose([broken, fast], (torch.ones(16, 16),)) is fast
        assert t.failures == [(qualname(broken), "ValueError")]

    @pytest.mark.parametrize("card", [False, True])
    def test_hand_kernel_failure(self, monkeypatch, card):
        """A hand kernel's entry that fails on CUDA arguments raises (and
        is counted); off the card it scores inf like any candidate."""
        def broken_kernel(x):
            raise ValueError("no launch")

        RT.hand_kernel(broken_kernel)
        monkeypatch.setattr(RT, "_on_card", lambda args: card)
        t = RuntimeAutoTuner(warmup=1, iters=1)
        if card:
            with pytest.raises(ValueError, match="no launch"):
                t.choose([broken_kernel, fast], (torch.ones(8, 8),))
            assert not t.cache
        else:
            assert t.choose([broken_kernel, fast],
                            (torch.ones(8, 8),)) is fast
        assert t.failures == [(qualname(broken_kernel), "ValueError")]

    def test_none_args_tolerated(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)

        def two(x, b):
            return x * 2

        def three(x, b):
            return x * 3

        assert t.choose([two, three], (torch.ones(8, 8), None)) in (
            two, three)
        (key,) = t.cache
        assert key[1] == (((8, 8), torch.float32), None)

    def test_default_tuner_roundtrip(self):
        assert get_default_tuner() is None
        t = RuntimeAutoTuner()
        set_default_tuner(t)
        assert get_default_tuner() is t

    def test_reference_alias(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        assert t.choose_function([fast], (torch.ones(4, 4),)) is fast
        assert RuntimeAutoTuner.choose_function is RuntimeAutoTuner.choose

    def test_synthesize_is_seeded_and_typed(self):
        sig = (((4, 8), torch.bfloat16), None, ((3,), torch.int64), "int")
        a = RuntimeAutoTuner._synthesize(sig, "cpu")
        b = RuntimeAutoTuner._synthesize(sig, "cpu")
        assert a[0].dtype == torch.bfloat16 and torch.equal(a[0], b[0])
        assert a[1] is None
        assert a[2].dtype == torch.int64 and not a[2].any()
        assert a[3] == 1


class TestPendingLifecycle:
    def test_choose_inside_deferring_records_pending(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        x = torch.ones(64, 64)
        with deferring():
            assert t.choose([slow, fast], (x,)) is slow  # candidate 0
            assert t.choose([slow, fast], (x,)) is slow  # one record
        assert len(t.pending) == 1 and not t.cache
        assert t.resolve_pending() == 1
        assert not t.pending and len(t.cache) == 1
        assert t.choose([slow, fast], (x,)) is fast
        assert t.resolve_pending() == 0

    def test_deferring_nests_and_unwinds(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        with pytest.raises(RuntimeError):
            with deferring():
                with deferring():
                    raise RuntimeError("boom")
        # outside again: timed at once
        assert t.choose([slow, fast], (torch.ones(8, 8),)) is fast
        assert not t.pending


class TestPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        x = torch.ones(64, 64)
        winner = t.choose([slow, fast], (x,))
        p = str(tmp_path / "tune.json")
        assert t.save(p) == 1
        with open(p) as f:
            data = json.load(f)
        assert data["version"] == 2 and set(data) == {"version", "winners",
                                                       "plans"}
        t2 = RuntimeAutoTuner(warmup=1, iters=1)
        t2._time_one = None  # nothing may be timed below
        assert t2.load(p) == 1
        assert t2.choose([slow, fast], (x,)) is winner
        assert len(t2.cache) == 1 and t2.version == 0
        # entries loaded and not re-hit survive the next save
        t3 = RuntimeAutoTuner()
        t3.load(p)
        assert t3.save(p) == 1

    def test_legacy_flat_table_loads(self, tmp_path):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        x = torch.ones(16, 16)
        t.choose([slow, fast], (x,))
        p = str(tmp_path / "flat.json")
        with open(p, "w") as f:
            json.dump({json.dumps(k, default=str): LIN._rt.qualname(fn)
                       for k, fn in t.cache.items()}, f)
        t2 = RuntimeAutoTuner()
        t2._time_one = None
        assert t2.load(p) == 1
        assert t2.choose([slow, fast], (x,)) is fast

    def test_stored_name_must_match_candidates(self, tmp_path):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        x = torch.ones(32, 32)
        t.choose([slow, fast], (x,))
        p = str(tmp_path / "tune.json")
        t.save(p)
        t2 = RuntimeAutoTuner(warmup=1, iters=1)
        t2.load(p)

        def other(z):
            return z * 2.0

        assert t2.choose([other, fast], (x,)) in (other, fast)
        assert t2.version == 1  # timed: the stored entry did not apply

    def test_jax_cache_file_resolves_to_nothing(self, tmp_path):
        """A JAX cache file's names (tiny_deepspeed_tpu.ops.linear...)
        match no live candidate of the port: its entries are ignored."""
        import jax.numpy as jnp
        from tiny_deepspeed_tpu.autotuner import RuntimeAutoTuner as JT
        from tiny_deepspeed_tpu.ops.linear import linear_forward as jlin
        jt = JT(warmup=1, iters=1)
        jlin(jnp.ones((2, 16, 32)), jnp.ones((32, 16)), jnp.ones((16,)),
             tuner=jt)
        p = str(tmp_path / "jax.json")
        assert jt.save(p) == 1
        t = RuntimeAutoTuner(warmup=1, iters=1)
        assert t.load(p) == 1
        LIN.linear_forward(torch.ones(2, 16, 32), torch.ones(32, 16),
                           torch.ones(16), tuner=t)
        assert t.version == 1  # timed anew


class TestDiagnostics:
    def test_failures_counted_and_records_valid(self, tmp_path):
        from tiny_deepspeed_tpu.telemetry import schema as jschema
        from tiny_deepspeed_tpu_torch.telemetry import schema as tschema
        from tiny_deepspeed_tpu_torch.utils.profiling import MetricsLogger
        path = str(tmp_path / "m.jsonl")
        tel = T.Telemetry()
        with MetricsLogger(path, stdout=False) as ml:
            t = RuntimeAutoTuner(warmup=1, iters=1)
            t.attach_diagnostics(tel, ml)
            assert t.choose([broken, fast], (torch.ones(8, 8),)) is fast
            # a real site's kernel candidate refuses CPU tensors
            x = torch.randn(4, 64)
            w, b = torch.ones(64), torch.zeros(64)
            impl = t.choose(LN._FWD_CANDIDATES, (x, w, b), eps=1e-5)
            assert impl is LN._ln_fwd_plain
        assert tel.counters["autotune_candidate_failures"].value == 2
        assert tel.gauges["autotune_candidate_failures"] == 2.0
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        events = [r["autotune"]["event"] for r in recs]
        assert events == ["candidate_failed", "decision"] * 2
        assert recs[1]["autotune"]["ranking"][0]["us"] is None
        for rec in recs:
            assert rec["kind"] == "run_meta"
            assert tschema.validate_record(rec) == []
            assert jschema.validate_record(rec) == []

    def test_verbose_prints_without_a_logger(self, capsys):
        t = RuntimeAutoTuner(warmup=1, iters=1, verbose=True)
        t.choose([broken, fast], (torch.ones(8, 8),))
        out = capsys.readouterr().out
        assert "broken failed: ValueError" in out
        assert "-> fast" in out


# -- the engine ---------------------------------------------------------------

def _tiny(**kw):
    return dataclasses.replace(T.GPT2_PRESETS["tiny"], fused_xent=True,
                               **kw)


def _batches(n, b=2, t=256):
    loader = T.TokenLoader(None, b, t, vocab_size=512, seed=3)
    return [loader.next() for _ in range(n)]


def _norm_sig(sig):
    """A site signature with the dtype names normalised across the two
    packages: PyTorch's "torch.float32" and JAX's "float32" both as
    "float32", and the token dtypes (JAX's int32, the port's int64) as
    "int"."""
    def one(e):
        if e is None:
            return None
        shape, dt = e
        dt = str(dt).replace("torch.", "")
        return tuple(shape), "int" if dt.startswith("int") else dt
    return tuple(one(e) for e in sig)


def _jax_tuned_run(batches, fp8="off"):
    """The JAX SingleDevice on the tiny preset (chunked head), tuned as
    examples/common.py tunes it: (params, pending signatures, retune's
    count, the losses)."""
    import jax
    import jax.numpy as jnp
    from tiny_deepspeed_tpu import AdamW as JAdamW
    from tiny_deepspeed_tpu import SingleDevice as JSingleDevice
    from tiny_deepspeed_tpu import make_mesh
    from tiny_deepspeed_tpu.autotuner import RuntimeAutoTuner as JT
    from tiny_deepspeed_tpu.autotuner import set_default_tuner as jset
    from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
    from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
    from tiny_deepspeed_tpu.ops.matmul_fp8 import fp8_matmul_forced
    jm = JaxGPT2(dataclasses.replace(JP["tiny"], fused_xent=True))
    jeng = JSingleDevice(jm, JAdamW(lr=1e-3, weight_decay=0.1),
                         mesh=make_mesh(devices=[jax.devices()[0]]))
    state = jeng.init(jax.random.PRNGKey(0))
    params = {k: np.asarray(v) for k, v in state.params.items()}
    tuner = JT(warmup=1, iters=1)
    jset(tuner)
    losses = []
    try:
        with fp8_matmul_forced(fp8):
            for i, (x, y) in enumerate(batches):
                state, loss = jeng.step(state, (jnp.asarray(x),
                                                jnp.asarray(y)))
                losses.append(float(loss))
                if i == 0:
                    sigs = sorted(_norm_sig(v[1])
                                  for v in tuner.pending.values())
                    n = jeng.retune()
    finally:
        jset(None)
    return params, sigs, n, losses


def _port_tuned_run(params, batches, fp8="off"):
    """The port's SingleDevice from `params`, tuned the same way."""
    pm = T.GPT2Model(_tiny(), device="cpu")
    eng = T.SingleDevice(pm, T.AdamW(lr=1e-3, weight_decay=0.1),
                         device="cpu")
    state = eng.init(0)
    pm.load_state_dict(T.params_from_numpy(params, "cpu"))
    tuner = RuntimeAutoTuner(warmup=1, iters=1)
    set_default_tuner(tuner)
    losses = []
    with F8.fp8_matmul_forced(fp8):
        for i, batch in enumerate(batches):
            state, loss = eng.step(state, batch)
            losses.append(float(loss))
            if i == 0:
                sigs = sorted(_norm_sig(v[1]) for v in tuner.pending.values())
                n = eng.retune()
    return sigs, n, losses, tuner


@pytest.fixture(scope="module")
def tuned_runs():
    batches = _batches(5)
    params, jsigs, jn, jl = _jax_tuned_run(batches)
    set_default_tuner(None)
    sigs, n, losses, tuner = _port_tuned_run(params, batches)
    set_default_tuner(None)
    return dict(jax=(jsigs, jn, jl), port=(sigs, n, losses), tuner=tuner)


class TestEngine:
    def test_lifecycle(self):
        pm = T.GPT2Model(_tiny(), device="cpu")
        eng = T.SingleDevice(pm, T.AdamW(lr=1e-3, fused="auto"),
                             device="cpu")
        state = eng.init(0)
        (idx, tgt), = _batches(1)
        assert eng.retune() == 0  # no tuner: nothing to do
        t = RuntimeAutoTuner(warmup=1, iters=1)
        set_default_tuner(t)
        state, l0 = eng.step(state, (idx, tgt))
        assert t.pending and not t.cache  # recorded, nothing timed
        assert eng.retune() > 0
        assert not t.pending
        state, l1 = eng.step(state, (idx, tgt))
        assert float(l1) <= float(l0) + 1.0
        assert eng.retune() == 0  # nothing left pending
        eng.revert_tune()
        assert get_default_tuner() is None
        state, l2 = eng.step(state, (idx, tgt))
        assert np.isfinite(float(l2))
        # eval_loss records too, and times nothing
        t2 = RuntimeAutoTuner(warmup=1, iters=1)
        set_default_tuner(t2)
        eng.eval_loss(state, (idx, tgt))
        assert t2.pending and not t2.cache

    def test_retune_sites_match_jax(self, tuned_runs):
        jsigs, jn, _ = tuned_runs["jax"]
        sigs, n, _ = tuned_runs["port"]
        assert n == jn == len(jsigs) == 5  # 4 linear shapes + the head
        assert sigs == jsigs
        names = sorted(k[0] for k in tuned_runs["tuner"].cache)
        assert names == sorted(
            [tuple(LIN._rt.qualname(f) for f in LIN._CANDIDATES_FWD)] * 4
            + [tuple(LIN._rt.qualname(f) for f in SX._candidates(256))])

    def test_tuned_losses_match_jax(self, tuned_runs):
        jl = tuned_runs["jax"][2]
        losses = tuned_runs["port"][2]
        np.testing.assert_allclose(losses, jl, rtol=1e-4)
        assert len(losses) == 5 and np.all(np.isfinite(losses))


def _dist_worker(rank, world, store, out_dir):
    """A gloo rank of a tiny DDP engine with a tuner whose timings
    disagree across ranks (rank 0 prefers each site's LAST candidate,
    rank 1 its first): after one step and `retune()` every rank holds
    rank 0's winners; then rank 0's timing raises, and so does every
    rank's `retune()`."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        def rank_time(self, fn, concrete, kw):
            order = self._order.setdefault(id(self), [])
            order.append(fn)
            return 1.0 / len(order) if rank == 0 else float(len(order))

        RuntimeAutoTuner._order = {}
        RuntimeAutoTuner._time_one = rank_time
        pm = T.GPT2Model(_tiny(), device="cpu")
        eng = T.DDP(pm, T.AdamW(lr=1e-3), device="cpu")
        state = eng.init(0)
        tuner = RuntimeAutoTuner()
        set_default_tuner(tuner)
        (idx, tgt), batch = _batches(2)
        state, _ = eng.step(state, (idx, tgt))
        n = eng.retune()
        state, loss = eng.step(state, batch)
        pending = len(tuner.pending)

        def rank0_raises(self, fn, concrete, kw):
            if rank == 0:  # as a hand kernel that failed on the card
                raise RuntimeError("kernel did not launch")
            return 1.0

        RuntimeAutoTuner._time_one = rank0_raises
        with deferring():
            tuner.choose([fast, slow], (torch.ones(4, 4),))
        try:
            eng.retune()
            err = None
        except RuntimeError as e:
            err = str(e)
        torch.save({"n": n, "table": tuner.winner_table(),
                    "loss": float(loss), "pending": pending, "err": err},
                   os.path.join(out_dir, f"{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_retune_at_data2_takes_rank0_winners(tmp_path):
    spawn(_dist_worker, 2, tmp_path)
    r0, r1 = (torch.load(tmp_path / f"{r}.pt", weights_only=False)
              for r in range(2))
    assert r0["n"] == r1["n"] == 5 and r0["pending"] == r1["pending"] == 0
    assert r1["table"] == r0["table"]
    # rank 0's timings chose each site's last candidate, not candidate 0
    assert all(name == k[0][-1] for k, name in r0["table"].items())
    assert r0["loss"] == r1["loss"]
    # an error in rank 0's timing is raised on every rank, no rank hangs
    assert r0["err"] == "kernel did not launch"
    assert "kernel did not launch" in r1["err"]


# -- the sites ----------------------------------------------------------------

def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32) * scale)


class TestSites:
    def test_linear_candidates_agree(self):
        x, w, b = _rand(2, 16, 32, seed=1), _rand(32, 8, seed=2), _rand(8)
        ref = LIN._fwd_batched(x, w, b)
        for f in LIN._CANDIDATES_FWD:
            torch.testing.assert_close(f(x, w, b), ref, rtol=1e-6,
                                       atol=1e-6)
        t = RuntimeAutoTuner(warmup=1, iters=1)
        y = LIN.linear_forward(x, w, b, tuner=t)
        assert y.shape == (2, 16, 8) and len(t.cache) == 1
        assert next(iter(t.cache.values())) in LIN._CANDIDATES_FWD
        with F8.fp8_matmul_forced("candidate"):
            t2 = RuntimeAutoTuner(warmup=1, iters=1)
            LIN.linear_forward(x, w, b, tuner=t2)
        ((names, _),) = t2.cache
        assert names == tuple(LIN._rt.qualname(f) for f in (
            LIN._fwd_batched, LIN._fwd_flat2d, F8._fwd_fp8))

    def test_linear_default_is_candidate_zero(self, monkeypatch):
        """No tuner, mode "off": linear runs `_fwd_batched` and consults
        nothing else."""
        calls = []
        monkeypatch.setattr(LIN, "_fwd_batched",
                            lambda *a: calls.append(1) or a[0][..., :1])
        monkeypatch.setattr(LIN, "_CANDIDATES_FWD", None)
        LIN.linear(torch.ones(2, 4), torch.ones(4, 3), None)
        assert calls == [1]

    def test_xent_variants_match(self):
        import jax.numpy as jnp
        from tiny_deepspeed_tpu.ops import softmax_xent as jsx
        x = _rand(2, 512, 32, seed=3)
        w = _rand(32, 64, seed=4, scale=0.1)
        tgt = torch.arange(2 * 512).reshape(2, 512) % 64
        ref = float(SX.softmax_cross_entropy(
            torch.einsum("btd,dv->btv", x, w), tgt))
        jx, jw, jt = (jnp.asarray(a.numpy()) for a in (x, w, tgt))
        assert set(SX._FLX_VARIANTS) == set(jsx._FLX_VARIANTS)
        for want, f in SX._FLX_VARIANTS.items():
            assert f.__name__ == jsx._FLX_VARIANTS[want].__name__
            got = float(f(x, w, tgt))
            np.testing.assert_allclose(got, ref, rtol=1e-5)
            np.testing.assert_allclose(
                got, float(jsx._FLX_VARIANTS[want](jx, jw, jt)), rtol=1e-5)
        assert [f.__name__ for f in SX._candidates(512)] == [
            "fused_linear_xent_c128", "fused_linear_xent_c64",
            "fused_linear_xent_c256"]
        assert len(SX._candidates(48)) == 1  # every chunk collapses to 48
        t = RuntimeAutoTuner(warmup=1, iters=1)
        set_default_tuner(t)
        np.testing.assert_allclose(float(SX.fused_linear_xent(
            x, w, tgt)), ref, rtol=1e-5)
        assert next(iter(t.cache.values())) in set(
            SX._FLX_VARIANTS.values())

    def test_layernorm_sites_one_candidate_on_the_cpu(self):
        t = RuntimeAutoTuner(warmup=1, iters=1)
        set_default_tuner(t)
        x, r = _rand(4, 64, seed=5), _rand(4, 64, seed=6)
        w, b = _rand(64, seed=7), _rand(64, seed=8)
        y, mean, rstd = LN.layernorm_fwd(x, w, b)
        LN.add_layernorm_fwd(x, r, w, b)
        LN.layernorm_bwd(x, x, w, mean, rstd)
        assert not t.cache and not t.pending
        for cands in (LN._FWD_CANDIDATES, LN._ADD_FWD_CANDIDATES,
                      LN._BWD_CANDIDATES):
            assert "cuda" in cands[0].__name__
            assert "plain" in cands[1].__name__

    def test_flash_site_has_one_candidate(self):
        from tiny_deepspeed_tpu_torch.ops import attention as A
        t = RuntimeAutoTuner()
        set_default_tuner(t)
        q = _rand(1, 2, 16, 8, seed=9)
        o = A.flash_attention(q, q, q)
        assert o.shape == q.shape and A._FLASH_CANDIDATES == (A._fa2_flash,)
        assert not t.cache and not t.pending


class TestAdamWAuto:
    KW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=1e-2,
              decoupled=False, maximize=False)

    def _jax_ref(self, p, g):
        import jax.numpy as jnp
        from tiny_deepspeed_tpu.optim.adamw import _xla_update
        z = jnp.zeros(p.shape, jnp.float32)
        return _xla_update(jnp.asarray(p.numpy()), jnp.asarray(g.numpy()),
                           z, z, jnp.asarray(1, jnp.int32), **self.KW)

    def test_with_a_tuner_matches_xla_update(self, monkeypatch):
        """The kernel-or-plain choice is a timed per-shape choice (the
        CUDA-leaf gate patched open: the kernel candidate's wrapper takes
        its plain version on CPU tensors); whichever won, the update is
        JAX's `_xla_update`."""
        monkeypatch.setattr(AW.AdamW, "_use_fused", lambda self, p: True)
        t = RuntimeAutoTuner(warmup=1, iters=1)
        set_default_tuner(t)
        opt = T.AdamW(lr=1e-3, fused="auto")
        n = 16 * 1024
        p, g = _rand(n, seed=10), _rand(n, seed=11, scale=0.1)
        st = opt.init_one("w", p)
        p0 = p.clone()
        live = (st["m"], st["v"])
        opt.update_one("w", p, g, st, 1)
        assert (st["m"], st["v"]) == live  # the same tensors, in place
        ((names, sig), winner), = t.cache.items()
        assert winner in AW._AUTO_CANDIDATES
        assert sig[-1] == "int"  # the step counter enters as a type
        ref_p, ref_m, ref_v = self._jax_ref(p0, g)
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(st["m"].numpy(), np.asarray(ref_m),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(st["v"].numpy(), np.asarray(ref_v),
                                   rtol=1e-6, atol=1e-7)

    def test_without_a_tuner_the_plain_update_on_the_cpu(self, monkeypatch):
        calls = []
        monkeypatch.setattr(AW, "_fused_update",
                            lambda *a, **k: calls.append(1))
        opt = T.AdamW(lr=1e-3, fused="auto", amsgrad=True,
                      state_dtype=torch.bfloat16)  # accepted silently
        plain = T.AdamW(lr=1e-3, amsgrad=True, state_dtype=torch.bfloat16)
        p, g = _rand(64, seed=12), _rand(64, seed=13)
        q = p.clone()
        s1, s2 = opt.init_one("w", p), plain.init_one("w", q)
        for step in (1, 2):
            opt.update_one("w", p, g, s1, step)
            plain.update_one("w", q, g, s2, step)
        assert not calls
        assert torch.equal(p, q)
        assert all(torch.equal(s1[k], s2[k]) for k in ("m", "v", "vmax"))

    def test_bogus_fused_raises(self):
        with pytest.raises(ValueError, match="True, False or 'auto'"):
            T.AdamW(fused="bogus")


# -- tune_e2e and the plan bridge ---------------------------------------------

def _measure(plan):
    """A deterministic objective with an interaction and a failing plan."""
    if plan["grad_comm"] == "fp8" and plan["grad_buckets"] == 4:
        raise RuntimeError("infeasible")
    cost = {"fp32": 3.0, "int8": 2.0, "fp8": 1.0}[plan["grad_comm"]]
    cost += {1: 1.0, 2: 0.5, 4: 0.25}[plan["grad_buckets"]]
    return cost + (0.0 if plan["hpz"] else 0.125)


SPACE = {"grad_comm": ["fp32", "int8", "fp8"], "grad_buckets": [1, 2, 4],
         "hpz": [False, True]}


class TestTuneE2E:
    @pytest.mark.parametrize("objective,rounds", [("min", 1), ("min", 2),
                                                  ("max", 1)])
    def test_search_matches_jax(self, objective, rounds):
        from tiny_deepspeed_tpu.autotuner import tune_e2e as jtune
        got = tune_e2e(_measure, SPACE, objective=objective, rounds=rounds)
        want = jtune(_measure, SPACE, objective=objective, rounds=rounds)
        assert got == want
        assert got[2][0]["plan"] == {"grad_comm": "fp32", "grad_buckets": 1,
                                     "hpz": False}

    def test_refusals_match_jax(self):
        from tiny_deepspeed_tpu.autotuner import tune_e2e as jtune

        def bad(plan):
            raise RuntimeError("no")

        for fn in (tune_e2e, jtune):
            with pytest.raises(ValueError, match="objective"):
                fn(_measure, SPACE, objective="fastest")
            with pytest.raises(RuntimeError, match="every candidate plan"):
                fn(bad, SPACE)

    def test_key_and_hash_match_jax(self):
        from tiny_deepspeed_tpu.autotuner import plan_hash as jhash
        from tiny_deepspeed_tpu.autotuner import plan_key as jkey
        plan = {"grad_comm": "int8", "grad_buckets": 4, "hpz": True,
                "scan_unroll": 1, "fp8": None}
        assert plan_key("gpt2-124m", "data4", "gpu") == jkey(
            "gpt2-124m", "data4", "gpu")
        assert plan_hash(plan) == jhash(plan)

    def test_plan_bridge_round_trip(self, tmp_path):
        from tiny_deepspeed_tpu.autotuner import RuntimeAutoTuner as JT
        from tiny_deepspeed_tpu.parallel.schedule import \
            comm_plan_engine_kwargs as jkwargs
        from tiny_deepspeed_tpu_torch.parallel.schedule import \
            comm_plan_engine_kwargs
        best, score, _ = tune_e2e(_measure, SPACE)
        key = plan_key("gpt2-124m", "data4", "gpu")
        t = RuntimeAutoTuner()
        h = t.store_plan(key, {**best, "gather_groups": None},
                         {"score": score})
        h2 = t.store_plan(key, {"gather_prefetch": 2}, {"runs": 3},
                          merge=True)
        assert h != h2
        p = str(tmp_path / "plans.json")
        t.save(p)
        t2 = RuntimeAutoTuner()
        t2.load(p)
        entry = t2.get_plan(key)
        assert entry["hash"] == h2 and entry["record"] == {"score": score,
                                                           "runs": 3}
        kw = comm_plan_engine_kwargs(entry["plan"])
        assert kw == {**best, "gather_prefetch": 2}
        jt = JT()
        jt.load(p)  # the JAX tuner reads the same envelope
        assert jkwargs(jt.get_plan(key)["plan"]) == kw
        assert t2.get_plan("other") is None


# -- the entry points ---------------------------------------------------------

def test_train_autotune_flag(tmp_path, capsys):
    """`train --autotune CACHE.json`: the probe step, `retune()`, the
    printed count, the cache written; a second run loads it and times
    nothing new."""
    from tiny_deepspeed_tpu_torch import train as TR
    path = str(tmp_path / "tune.json")
    argv = ["--device", "cpu", "--model", "tiny", "--iters", "2",
            "--seq-len", "256", "--batch-per-device", "2", "--fused-xent",
            "chunked", "--autotune", path]
    TR.main(argv)
    out = capsys.readouterr().out
    assert "autotuned 5 site(s)" in out and "iter   1 loss" in out
    with open(path) as f:
        assert len(json.load(f)["winners"]) == 5
    TR.main(argv)  # every site a stored hit: nothing left to time
    assert "autotuned 0 site(s)" in capsys.readouterr().out


def test_train_autotune_fails_on_a_candidate_failure(tmp_path, monkeypatch,
                                                     capsys):
    """A candidate that fails while timed ends `train --autotune` with an
    error, and no cache is saved."""
    from tiny_deepspeed_tpu_torch import train as TR

    def _fwd_broken(x, w, b):
        raise ValueError("unsupported shapes")

    monkeypatch.setattr(LIN, "_CANDIDATES_FWD",
                        (LIN._fwd_batched, _fwd_broken))
    path = str(tmp_path / "tune.json")
    with pytest.raises(SystemExit, match="candidate"):
        TR.main(["--device", "cpu", "--model", "tiny", "--iters", "1",
                 "--seq-len", "64", "--batch-per-device", "2",
                 "--autotune", path])
    assert "_fwd_broken failed" in capsys.readouterr().out
    assert not os.path.exists(path)
