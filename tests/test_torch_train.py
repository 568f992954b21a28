# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Single-device training of the PyTorch port against the JAX package,
on the CPU.

The JAX package's `tiny` preset (f32) is initialised from a seed and its
weights cross to the port through numpy.  Pinned here:

- the whole-model loss and every parameter's gradient equal
  `jax.value_and_grad(model.apply)` within rtol 1e-4, and the remat
  policies give bit-identical gradients;
- AdamW / SGD updates and state, and the four lr schedules, equal the
  JAX optimizers';
- `TokenLoader` yields the JAX loader's numpy stream batch for batch;
- a 20-step `SingleDevice` loss trajectory equals the JAX `SingleDevice`
  (one-device mesh) within 1e-4 relative at every step, and so do grad
  clipping, static and dynamic loss scaling (with a forced overflow
  skip) and `accum_steps=2`;
- refused knobs raise, entry points without CUDA and without an explicit
  CPU device raise, and `python -m tiny_deepspeed_tpu_torch.train`
  runs on the CPU.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu import SGD as JSGD
from tiny_deepspeed_tpu import AdamW as JAdamW
from tiny_deepspeed_tpu import SingleDevice as JSingleDevice
from tiny_deepspeed_tpu import make_mesh
from tiny_deepspeed_tpu.data import TokenLoader as JTokenLoader
from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from tiny_deepspeed_tpu.optim import schedule as jsched
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.optim import schedule as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _pair(**overrides):
    """(jax model, jax params, port model) on the tiny preset with the
    same weights."""
    jm = JaxGPT2(dataclasses.replace(JAX_PRESETS["tiny"], **overrides))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                         **overrides), device="cpu")
    pm.load_state_dict(T.params_from_numpy(_np(jp), "cpu"))
    return jm, jp, pm


def _batch(b=2, t=32, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, t)), rng.integers(0, vocab, (b, t))


def _port_loss_grads(pm, idx, tgt):
    loss = pm.apply(torch.from_numpy(idx), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    return float(loss.detach()), {n: g for (n, _), g in
                         zip(pm.named_parameters(), grads)}


class TestModelGrads:
    @pytest.mark.parametrize("overrides", [
        {}, dict(tie_weights=True), dict(bias=False),
        dict(wte_max_norm=0.5), dict(attn_impl="standard_attention"),
    ], ids=["default", "tied", "no_bias", "max_norm", "standard_attn"])
    def test_loss_and_grads_match_jax(self, overrides):
        jm, jp, pm = _pair(**overrides)
        idx, tgt = _batch(t=40)
        jl, jg = jax.value_and_grad(jm.apply)(jp, jnp.asarray(idx),
                                              jnp.asarray(tgt))
        loss, grads = _port_loss_grads(pm, idx, tgt)
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        assert set(grads) == set(jg)
        for n, g in grads.items():
            assert g.dtype == torch.float32, n
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]),
                                       err_msg=n, **GRAD_TOL)

    def test_remat_policies_give_identical_grads(self):
        idx, tgt = _batch(t=48, seed=1)
        ref = None
        for remat, policy in ((False, "dots_no_batch"), (True, "nothing"),
                              (True, "dots_no_batch"), (True, "dots"),
                              (True, "all")):
            _, _, pm = _pair(remat=remat, remat_policy=policy)
            loss, grads = _port_loss_grads(pm, idx, tgt)
            if ref is None:
                ref = (loss, grads)
                continue
            assert loss == ref[0]
            for n, g in grads.items():
                assert torch.equal(g, ref[1][n]), (policy, n)

    def test_eval_is_graph_free_and_loss_matches_logits(self):
        _, _, pm = _pair()
        idx, tgt = _batch(t=16, seed=2)
        with torch.no_grad():
            loss = pm.apply(torch.from_numpy(idx), torch.from_numpy(tgt))
        assert not loss.requires_grad
        logits = pm.apply(torch.from_numpy(idx), position=5)
        assert not logits.requires_grad and logits.shape == (2, 1, 512)


def _opt_params(rng):
    return {"h.attn.qkv.w": rng.standard_normal((2, 8, 24)),
            "h.ln_1.b": rng.standard_normal((2, 8)),
            "wte": rng.standard_normal((16, 8))}


class TestOptimizers:
    @pytest.mark.parametrize("kw", [
        dict(), dict(decoupled=True), dict(amsgrad=True),
        dict(maximize=True), dict(decay_exclude=(".b", "ln_")),
        dict(state_dtype="bf16"), dict(lr="warmup_cosine"),
    ], ids=["plain", "decoupled", "amsgrad", "maximize", "decay_exclude",
            "bf16_state", "schedule"])
    def test_adamw_matches_jax(self, kw):
        kw = dict(kw)
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("state_dtype") == "bf16":
            jkw["state_dtype"], tkw["state_dtype"] = (jnp.bfloat16,
                                                      torch.bfloat16)
        if kw.get("lr") == "warmup_cosine":
            jkw["lr"] = jsched.warmup_cosine(1e-2, 3, warmup_steps=1)
            tkw["lr"] = tsched.warmup_cosine(1e-2, 3, warmup_steps=1)
        self._three_steps(JAdamW(weight_decay=0.1, **jkw),
                          T.AdamW(weight_decay=0.1, **tkw))

    @pytest.mark.parametrize("kw", [
        dict(), dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
        dict(momentum=0.9, dampening=0.5, weight_decay=0.1),
        dict(maximize=True, weight_decay=0.1, decay_exclude=("wte",)),
    ], ids=["plain", "momentum", "nesterov", "dampening_wd", "maximize"])
    def test_sgd_matches_jax(self, kw):
        self._three_steps(JSGD(lr=0.1, **kw), T.SGD(lr=0.1, **kw))

    @staticmethod
    def _three_steps(jopt, topt):
        rng = np.random.default_rng(0)
        params = {k: v.astype(np.float32)
                  for k, v in _opt_params(rng).items()}
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        tp = T.params_from_numpy(params, "cpu")
        js, ts = jopt.init(jp), topt.init(tp)
        for _ in range(3):
            grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in params.items()}
            jp, js = jopt.update(jp, {k: jnp.asarray(g)
                                      for k, g in grads.items()}, js)
            tp2, ts = topt.update(tp, T.params_from_numpy(grads, "cpu"), ts)
            assert tp2 is tp  # in place
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        got = T.opt_state_to_numpy(ts)
        assert got["step"] == int(js["step"]) == 3
        for k, slots in js["state"].items():
            assert set(got["state"][k]) == set(slots)
            for s, v in slots.items():
                np.testing.assert_allclose(
                    got["state"][k][s], np.asarray(v, np.float32),
                    rtol=1e-5, atol=1e-6, err_msg=f"{k}.{s}")
        back = T.opt_state_from_numpy(got, "cpu")
        assert back["step"] == 3
        for k, slots in got["state"].items():
            for s, v in slots.items():
                np.testing.assert_array_equal(back["state"][k][s].numpy(), v)

    @pytest.mark.parametrize("name,kw", [
        ("constant", {}), ("warmup_linear", dict(total_steps=10,
                                                 warmup_steps=3,
                                                 min_lr=1e-4)),
        ("warmup_cosine", dict(total_steps=10, warmup_steps=3,
                               min_lr=1e-4)),
        ("inverse_sqrt", dict(warmup_steps=4)),
    ])
    def test_schedules_match_jax(self, name, kw):
        j = jsched.SCHEDULES[name](1e-3, **kw)
        t = tsched.SCHEDULES[name](1e-3, **kw)
        for step in range(14):
            np.testing.assert_allclose(
                t(step), float(j(jnp.int32(step))), rtol=1e-6, atol=1e-12)


class TestTokenLoader:
    def _same(self, jl, tl, n=3):
        for _ in range(n):
            (jx, jy), (tx, ty) = jl.next(), tl.next()
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            assert tx.dtype == np.int32

    def test_synthetic_stream(self):
        self._same(JTokenLoader(None, 3, 16, vocab_size=100, seed=4,
                                force_numpy=True),
                   T.TokenLoader(None, 3, 16, vocab_size=100, seed=4))

    def test_corpus_seek_and_indexed(self, tmp_path):
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 60000, 5000).astype(
            np.uint16).tofile(path)
        jl = JTokenLoader(path, 2, 32, seed=1, force_numpy=True)
        tl = T.TokenLoader(path, 2, 32, seed=1)
        self._same(jl, tl, 2)
        jl.seek_samples(10)
        tl.seek_samples(10)
        self._same(jl, tl, 2)
        with pytest.raises(ValueError, match="batch-aligned"):
            tl.seek_samples(tl.samples_seen + 1)
        for p in (path, None):
            jl = JTokenLoader(p, 3, 8, vocab_size=50, seed=2, indexed=True)
            tl = T.TokenLoader(p, 3, 8, vocab_size=50, seed=2, indexed=True)
            jl.seek_samples(5)
            tl.seek_samples(5)
            self._same(jl, tl, 2)


def _engines(steps_kw=None, cfg=None, **engine_kw):
    """(jax engine, jax state, port engine, port state) with the same
    weights on the tiny preset, AdamW(lr=1e-3, wd=0.1)."""
    cfg = cfg or {}
    jm = JaxGPT2(dataclasses.replace(JAX_PRESETS["tiny"], **cfg))
    jeng = JSingleDevice(jm, JAdamW(lr=1e-3, weight_decay=0.1),
                         mesh=make_mesh(devices=[jax.devices()[0]]),
                         **engine_kw)
    jstate = jeng.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **cfg),
                     device="cpu")
    teng = T.SingleDevice(pm, T.AdamW(lr=1e-3, weight_decay=0.1),
                          device="cpu", **engine_kw)
    tstate = teng.init(0)
    pm.load_state_dict(T.params_from_numpy(_np(jstate.params), "cpu"))
    return jeng, jstate, teng, tstate


def _batches(n, accum=1, b=2, t=32):
    loader = T.TokenLoader(None, b * accum, t, vocab_size=512, seed=3)
    out = []
    for _ in range(n):
        x, y = loader.next()
        if accum > 1:
            x, y = x.reshape(accum, b, t), y.reshape(accum, b, t)
        out.append((x, y))
    return out


def _run(jeng, jstate, teng, tstate, batches):
    jl, tl = [], []
    for x, y in batches:
        jstate, loss = jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))
        tstate, loss = teng.step(tstate, (x, y))
        tl.append(float(loss))
    return np.asarray(jl), np.asarray(tl), jstate, tstate


class TestSingleDevice:
    def test_20_step_trajectory_matches_jax(self):
        jl, tl, jstate, tstate = _run(*_engines(), _batches(20))
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        assert tl[-1] < tl[0]
        assert tstate.opt_state["step"] == int(jstate.opt_state["step"])
        # Adam's normalized step turns 1e-7-level differences of near-zero
        # gradients into differences of up to one step (lr = 1e-3) on a
        # few elements; the loss trajectory above is the tight pin
        for n, p in tstate.params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jstate.params[n]),
                                       atol=1e-3, err_msg=n)

    @pytest.mark.parametrize("kw,accum", [
        (dict(grad_clip=0.5), 1), (dict(loss_scale=128.0), 1),
        (dict(loss_scale="dynamic", loss_scale_growth_interval=2), 1),
        (dict(accum_steps=2), 2),
    ], ids=["grad_clip", "static_scale", "dynamic_scale", "accum2"])
    def test_engine_knobs_match_jax(self, kw, accum):
        jl, tl, jstate, tstate = _run(*_engines(**kw),
                                      _batches(5, accum=accum))
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        if kw.get("loss_scale") == "dynamic":
            # 5 clean steps at growth interval 2: 2^15 -> 2^16 -> 2^17
            assert tstate.scaler == {"scale": 2.0 ** 17, "good": 1}
            assert float(jstate.scaler["scale"]) == 2.0 ** 17

    def test_dynamic_scale_overflow_skips_like_jax(self):
        """A scale of 2^127 and a 10x lm_head (gradients up to ~3) make
        the first step's scaled gradients overflow f32: both engines skip
        it (params, moments and step counter kept) and halve the scale,
        then train on."""
        jeng, jstate, teng, tstate = _engines(loss_scale="dynamic")
        big = 2.0 ** 127
        jstate = jstate.replace(
            scaler={"scale": jnp.float32(big), "good": jnp.int32(0)},
            params=dict(jstate.params,
                        **{"lm_head.w": jstate.params["lm_head.w"] * 10}))
        tstate.scaler = {"scale": big, "good": 0}
        with torch.no_grad():
            tstate.params["lm_head.w"].mul_(10)
        batches = _batches(4)
        before = {n: p.detach().clone() for n, p in tstate.params.items()}
        tstate, _ = teng.step(tstate, batches[0])
        assert tstate.opt_state["step"] == 0
        assert tstate.scaler == {"scale": big / 2, "good": 0}
        assert all(torch.equal(p, before[n])
                   for n, p in tstate.params.items())
        jstate, _ = jeng.step(jstate, tuple(map(jnp.asarray, batches[0])))
        assert int(jstate.opt_state["step"]) == 0
        jl, tl, jstate, tstate = _run(jeng, jstate, teng, tstate,
                                      batches[1:])
        np.testing.assert_array_equal(np.isfinite(tl), np.isfinite(jl))
        fin = np.isfinite(jl)
        np.testing.assert_allclose(tl[fin], jl[fin], rtol=1e-4)
        assert tstate.scaler["scale"] == float(jstate.scaler["scale"])
        assert tstate.scaler["good"] == int(jstate.scaler["good"])
        assert tstate.opt_state["step"] == int(jstate.opt_state["step"]) > 0
        for n, p in tstate.params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jstate.params[n]),
                                       atol=1e-3, err_msg=n)

    def test_eval_loss_matches_jax(self):
        jeng, jstate, teng, tstate = _engines()
        x, y = _batches(1)[0]
        np.testing.assert_allclose(
            float(teng.eval_loss(tstate, (x, y))),
            float(jeng.eval_loss(jstate, (jnp.asarray(x), jnp.asarray(y)))),
            rtol=1e-5)


class TestRefusalsAndEntryPoints:
    @pytest.mark.parametrize("knob", [
        dict(gather_quant="fp16"), dict(remat_policy="everything"),
    ], ids=["gather_quant", "remat_policy"])
    def test_refused_model_knobs_raise(self, knob):
        cfg = dataclasses.replace(T.GPT2_PRESETS["tiny"], **knob)
        with pytest.raises(ValueError):
            T.GPT2Model(cfg, device="cpu")

    @pytest.mark.parametrize("knob", [
        dict(telemetry=object()), dict(offload_opt_state=True),
        dict(grad_comm="int8"), dict(grad_buckets=2),
        dict(gather_prefetch=2), dict(hpz=True), dict(seq_parallel=2),
        dict(tensor_parallel=2), dict(expert_parallel=2),
        dict(pipeline_parallel=2),
    ])
    def test_refused_engine_knobs_raise(self, knob):
        """The knobs still refused say so; the schedule's are inert on
        one device, with JAX's warning, and run the plain path bit for
        bit; the telemetry and the offload build, and `describe()` names
        them (tests/test_torch_telemetry.py, tests/test_torch_offload.py
        run them)."""
        pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
        if "telemetry" in knob or "offload_opt_state" in knob:
            eng = T.SingleDevice(pm, T.AdamW(), device="cpu", **knob)
            assert eng._schedule.lowering == "plain"
            assert eng.describe().endswith(
                ", telemetry=on)" if "telemetry" in knob
                else ", opt state offloaded=pinned_host)")
            return
        if set(knob) & {"grad_buckets", "gather_prefetch", "hpz",
                        "grad_comm"}:
            batches = [T.TokenLoader(None, 2, 16, vocab_size=512,
                                     seed=3).next() for _ in range(2)]
            out = []
            for kw in ({}, knob):
                m = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    eng = T.SingleDevice(m, T.AdamW(lr=1e-3), device="cpu",
                                         **kw)
                assert any("inert" in str(x.message) for x in w) == bool(kw)
                assert eng._schedule.lowering == "plain"
                st = eng.init(0)
                out.append(([float(eng.step(st, b)[1]) for b in batches],
                            eng.gather_params(st)))
            assert out[0][0] == out[1][0]
            for n, p in out[0][1].items():
                assert torch.equal(out[1][1][n], p), n
            return
        with pytest.raises(ValueError, match="not ported"):
            T.SingleDevice(pm, T.AdamW(), device="cpu", **knob)

    def test_without_cuda_entry_points_raise(self, monkeypatch):
        pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.SingleDevice(pm, T.AdamW())
        from tiny_deepspeed_tpu_torch import train
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--model", "tiny", "--iters", "1"])

    def test_train_module_runs_on_cpu(self):
        out = subprocess.run(
            [sys.executable, "-m", "tiny_deepspeed_tpu_torch.train",
             "--device", "cpu", "--model", "tiny", "--iters", "3",
             "--seq-len", "64", "--eval-every", "3", "--eval-batches", "1",
             "--lr-schedule", "warmup_cosine", "--warmup-steps", "1",
             "--grad-clip", "1.0", "--wd-exclude", ".b,ln_"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        assert [ln.split()[:2] for ln in lines if " loss " in ln] == [
            ["iter", "0"], ["iter", "1"], ["iter", "2"]]
        assert any("val_loss" in ln for ln in lines)
        assert lines[-1].startswith("done: 3 iters in ")
        assert "tokens/s" in lines[-1]

    @pytest.mark.parametrize("engine", ["single", "zero3"])
    def test_train_module_runs_gather_quant_fp8(self, engine):
        """--gather-quant fp8 constructs and trains, on one device and
        under ZeRO-3 (a world of one without torchrun)."""
        out = subprocess.run(
            [sys.executable, "-m", "tiny_deepspeed_tpu_torch.train",
             "--device", "cpu", "--model", "tiny", "--iters", "3",
             "--seq-len", "64", "--engine", engine, "--gather-quant",
             "fp8"], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        losses = [float(ln.split()[-1]) for ln in lines if " loss " in ln]
        assert len(losses) == 3 and all(np.isfinite(losses))
        assert lines[-1].startswith("done: 3 iters in ")
        if engine == "zero3":
            assert "params sharded=True" in lines[0]
