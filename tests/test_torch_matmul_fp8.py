# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's fp8 (e4m3) matmuls (`ops/matmul_fp8.py`) against the JAX
package's, on the CPU, where both upcast the e4m3 codes to f32 for the
product:

- the modes: `set_fp8_matmul` refuses a bad mode with JAX's message,
  `fp8_matmul_forced` restores the mode;
- `_quantize`'s codes and scales are JAX's bit for bit (clipped values
  included);
- `fp8_matmul`, `_fwd_fp8` and `fp8_matmul_delayed` (a cold history,
  the roll, a current amax above the history) within 1e-6 relative
  (the delayed products: 1e-6 of the output's largest magnitude, the
  two f32 products summing in different orders);
- under "on": `linear`'s output and its dx / dw / db against JAX's
  custom-vjp cotangents (1e-5); `fused_linear_xent`'s loss and gradients
  (1e-5); a 5-step SingleDevice run (1e-4);
- under "off" nothing is quantized: `linear`, the chunked head and a
  whole training step never reach `_quantize`.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu import AdamW as JAdamW
from tiny_deepspeed_tpu import SingleDevice as JSingleDevice
from tiny_deepspeed_tpu import make_mesh
from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from tiny_deepspeed_tpu.ops import matmul_fp8 as J8
from tiny_deepspeed_tpu.ops import softmax_xent as jsx
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.ops import linear as LIN
from tiny_deepspeed_tpu_torch.ops import matmul_fp8 as F8
from tiny_deepspeed_tpu_torch.ops import softmax_xent as SX

# the module (the package re-exports its `linear` under the same name)
jlin = importlib.import_module("tiny_deepspeed_tpu.ops.linear")


@pytest.fixture(autouse=True)
def _mode_off():
    """Every test starts and ends in mode "off" on both sides."""
    F8.set_fp8_matmul("off")
    J8.set_fp8_matmul("off")
    yield
    F8.set_fp8_matmul("off")
    J8.set_fp8_matmul("off")


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


def test_modes_match_jax():
    assert F8.FP8_MATMUL_MODES == J8.FP8_MATMUL_MODES
    assert F8.E4M3_MAX == J8.E4M3_MAX
    with pytest.raises(ValueError) as got:
        F8.set_fp8_matmul("half")
    with pytest.raises(ValueError) as want:
        J8.set_fp8_matmul("half")
    assert str(got.value) == str(want.value)
    assert F8.fp8_matmul_mode() == "off"
    with F8.fp8_matmul_forced("candidate"):
        assert F8.fp8_matmul_mode() == "candidate"
        with F8.fp8_matmul_forced("on"):
            assert F8.fp8_matmul_mode() == "on"
        assert F8.fp8_matmul_mode() == "candidate"
    assert F8.fp8_matmul_mode() == "off"


@pytest.mark.parametrize("amax_scale", [1.0, 0.25],
                         ids=["just_in_time", "stale_amax_clips"])
def test_quantize_codes_bit_for_bit(amax_scale):
    x = _rand(64, 96, seed=1) * np.logspace(-3, 3, 96, dtype=np.float32)
    amax = np.abs(x).max(axis=-1, keepdims=True) * amax_scale
    q, s = F8._quantize(_t(x), _t(amax))
    jq, js = J8._quantize(jnp.asarray(x), jnp.asarray(amax))
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(q.float().numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if amax_scale < 1:  # the clip reached e4m3's largest value
        assert q.float().abs().max() == 448.0


def test_fp8_matmul_and_candidate_match_jax():
    x = _rand(2, 24, 64, seed=2)
    w = _rand(64, 48, seed=3, scale=0.05)
    b = _rand(48, seed=4)
    _close(F8.fp8_matmul(_t(x), _t(w)),
           J8.fp8_matmul(jnp.asarray(x), jnp.asarray(w)))
    _close(F8._fwd_fp8(_t(x), _t(w), _t(b)),
           J8._fwd_fp8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           atol=1e-6)
    _close(F8._fwd_fp8(_t(x), _t(w), None),
           J8._fwd_fp8(jnp.asarray(x), jnp.asarray(w), None))
    # the quantization error is e4m3's: well under 10% of the output scale
    exact = _t(x) @ _t(w)
    assert (F8.fp8_matmul(_t(x), _t(w)) - exact).abs().max() \
        < 0.1 * exact.abs().max()


def test_fp8_matmul_delayed_matches_jax():
    hist = F8.fp8_history(4, device="cpu")
    jhist = J8.fp8_history(4)
    assert hist.x_amax.shape == (4,) and hist.x_amax.dtype == torch.float32
    w = _rand(32, 16, seed=5)
    # a cold history, two rolls, then a step whose amax outruns it
    for i, scale in enumerate((1.0, 0.5, 0.75, 4.0)):
        x = _rand(8, 32, seed=10 + i, scale=scale)
        y, hist = F8.fp8_matmul_delayed(_t(x), _t(w), hist)
        jy, jhist = J8.fp8_matmul_delayed(jnp.asarray(x), jnp.asarray(w),
                                          jhist)
        # relative to the output's scale: the two f32 products sum in
        # different orders
        _close(y, jy, atol=1e-6 * float(np.abs(jy).max()))
        np.testing.assert_array_equal(hist.x_amax.numpy(),
                                      np.asarray(jhist.x_amax))
        np.testing.assert_array_equal(hist.w_amax.numpy(),
                                      np.asarray(jhist.w_amax))
    assert float(hist.x_amax[0]) > float(hist.x_amax[1:].max())


def test_linear_under_on_matches_jax_vjp():
    x = _rand(2, 16, 32, seed=6)
    w = _rand(32, 48, seed=7, scale=0.1)
    b = _rand(48, seed=8)
    gy = _rand(2, 16, 48, seed=9)
    tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, b))
    with F8.fp8_matmul_forced("on"):
        y = LIN.linear(tx, tw, tb)
    y.backward(_t(gy))
    with J8.fp8_matmul_forced("on"):
        jy, vjp = jax.vjp(jlin.linear, jnp.asarray(x), jnp.asarray(w),
                          jnp.asarray(b))
        jdx, jdw, jdb = vjp(jnp.asarray(gy))
    _close(y, jy, atol=1e-6)
    _close(tx.grad, jdx, rtol=1e-5, atol=1e-6)
    _close(tw.grad, jdw, rtol=1e-5, atol=1e-6)
    _close(tb.grad, jdb, rtol=1e-5, atol=1e-6)
    # the backward is the closed form on the unquantized operands
    _close(tw.grad, x.reshape(-1, 32).T @ gy.reshape(-1, 48), rtol=1e-5,
           atol=1e-5)


def test_fused_linear_xent_under_on_matches_jax():
    x = _rand(2, 256, 32, seed=11)
    w = _rand(32, 64, seed=12, scale=0.1)
    tgt = (np.arange(2 * 256).reshape(2, 256) * 7) % 64
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    with F8.fp8_matmul_forced("on"):
        loss = SX.fused_linear_xent(tx, tw, _t(tgt))
    loss.backward()
    with J8.fp8_matmul_forced("on"):
        jl, (jdx, jdw) = jax.value_and_grad(
            lambda a, c: jsx.fused_linear_xent(a, c, jnp.asarray(tgt)),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(loss, jl, rtol=1e-5)
    _close(tx.grad, jdx, rtol=1e-5, atol=1e-7)
    _close(tw.grad, jdw, rtol=1e-5, atol=1e-7)
    # and it is not the unquantized head
    ref = SX.fused_linear_xent(_t(x), _t(w), _t(tgt))
    assert float(loss.detach()) != float(ref)


def _batches(n, b=2, t=64):
    loader = T.TokenLoader(None, b, t, vocab_size=512, seed=3)
    return [loader.next() for _ in range(n)]


def test_single_device_under_on_matches_jax():
    cfg = dict(fused_xent=True)
    jm = JaxGPT2(dataclasses.replace(JP["tiny"], **cfg))
    jeng = JSingleDevice(jm, JAdamW(lr=1e-3, weight_decay=0.1),
                         mesh=make_mesh(devices=[jax.devices()[0]]))
    jstate = jeng.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **cfg),
                     device="cpu")
    teng = T.SingleDevice(pm, T.AdamW(lr=1e-3, weight_decay=0.1),
                          device="cpu")
    tstate = teng.init(0)
    pm.load_state_dict(T.params_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()}, "cpu"))
    jl, tl = [], []
    with J8.fp8_matmul_forced("on"), F8.fp8_matmul_forced("on"):
        for x, y in _batches(5):
            jstate, loss = jeng.step(jstate, (jnp.asarray(x),
                                              jnp.asarray(y)))
            jl.append(float(loss))
            tstate, loss = teng.step(tstate, (x, y))
            tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_off_issues_no_quantization(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("quantized under mode 'off'")

    monkeypatch.setattr(F8, "_quantize", refuse)
    x = torch.randn(2, 8, 16, requires_grad=True)
    LIN.linear(x, torch.randn(16, 8), torch.randn(8)).sum().backward()
    SX.fused_linear_xent(x, torch.randn(16, 32),
                         torch.zeros(2, 8, dtype=torch.long)).backward()
    for fused in (False, True):
        pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                             fused_xent=fused), device="cpu")
        eng = T.SingleDevice(pm, T.AdamW(lr=1e-3), device="cpu")
        state = eng.init(0)
        state, loss = eng.step(state, _batches(1)[0])
        assert np.isfinite(float(loss))
    with F8.fp8_matmul_forced("on"), pytest.raises(AssertionError,
                                                   match="quantized"):
        LIN.linear(x, torch.randn(16, 8), None)
