# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Optimizer-state offload (`offload_opt_state`, `offload_prefetch`;
parallel/offload.py) on the CPU, where the resting moments are separate
CPU tensors and the same streaming code runs leaf by leaf.

JAX cannot run its offload on the CPU (XLA's CPU backend has no
placement custom-call: tests/test_offload.py), and its `_offload_update`
is `update_one` leaf by leaf by construction.  So the reference is JAX's
unoffloaded engine, and the port's offloaded engine must be bit for bit
the port's unoffloaded one.  Pinned here:

- SingleDevice on the tiny preset at `offload_prefetch` 1, 2 and 4, 5
  steps, under AdamW and SGD: losses, params and every moment bit for
  bit the unoffloaded run; the moments rest in the host tensors `init`
  made, updated in place; the losses within 1e-4 relative of JAX's
  unoffloaded `SingleDevice` (tests/test_torch_train.py's rule), the
  params and moments within 1e-5 (tests/test_torch_dist.py's rule:
  under AdamW on the elements whose gradient RMS stayed at or above
  1e-5, at least 99% of them; under SGD every element);
  `describe()` names the placement;
- JAX's two refusals with JAX's messages: `offload_prefetch < 1`, and an
  optimizer that overrides `update()`;
- a dynamic-scale step that overflows streams nothing: params, moments
  and the counter kept;
- 3 steps, save, a fresh offloaded engine loaded, 3 more: bit for bit
  the straight run, the restored moments back in host tensors.

tests/test_torch_checkpoint.py holds Zero1 and Zero3 under offload at
data 2 over gloo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu as J
from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.utils import checkpoint as ck

STEPS = 5


def _opts(name):
    if name == "sgd":
        return (J.SGD(lr=1e-2, momentum=0.9, weight_decay=0.1),
                T.SGD(lr=1e-2, momentum=0.9, weight_decay=0.1))
    return (J.AdamW(lr=1e-3, weight_decay=0.1),
            T.AdamW(lr=1e-3, weight_decay=0.1))


def _batches(n):
    loader = T.TokenLoader(None, 2, 32, vocab_size=512, seed=3)
    return [loader.next() for _ in range(n)]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's unoffloaded SingleDevice, 5 steps, per optimizer: (init
    params, losses, final state as numpy, each element's least
    bias-corrected gradient RMS over the steps — AdamW's)."""
    out = {}
    for name in ("adamw", "sgd"):
        jopt = _opts(name)[0]
        jeng = J.SingleDevice(JGPT2(JP["tiny"]), jopt,
                              mesh=J.make_mesh(devices=[jax.devices()[0]]))
        st = jeng.init(jax.random.PRNGKey(0))
        init = {n: np.asarray(p) for n, p in st.params.items()}
        losses, rms = [], {n: np.inf for n in init}
        for x, y in _batches(STEPS):
            st, loss = jeng.step(st, (jnp.asarray(x), jnp.asarray(y)))
            losses.append(float(loss))
            if name == "adamw":
                t = int(st.opt_state["step"])
                for n in rms:
                    v = np.asarray(st.opt_state["state"][n]["v"])
                    rms[n] = np.minimum(rms[n],
                                        np.sqrt(v / (1 - jopt.b2 ** t)))
        final = {n: {"param": np.asarray(p),
                     **{k: np.asarray(t) for k, t in
                        st.opt_state["state"][n].items()}}
                 for n, p in st.params.items()}
        out[name] = (init, np.asarray(losses), final, rms)
    return out


def _held_to_jax(params, opt_state, final, rms, opt):
    """tests/test_torch_dist.py's rule at 1e-5 (AdamW: v as the bias-
    corrected RMS, held elements only, at least 99% held)."""
    bc2 = 1 - 0.999 ** STEPS
    held = total = 0
    for n, p in params.items():
        slots = opt_state["state"][n]
        pairs = {"param": p.detach().numpy(),
                 **{k: t.numpy() for k, t in slots.items()}}
        keep = (np.ones(p.shape, bool) if opt == "sgd" else
                np.broadcast_to(rms[n] >= 1e-5, p.shape))
        held += keep.sum()
        total += p.numel()
        for k, got in pairs.items():
            want = final[n][k]
            if k == "v":
                got, want = np.sqrt(got / bc2), np.sqrt(want / bc2)
            np.testing.assert_allclose(got[keep], want[keep], atol=1e-5,
                                       err_msg=f"{n}.{k}")
    assert held >= 0.99 * total


def _engine(opt, init, **kw):
    eng = T.SingleDevice(T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu"),
                         _opts(opt)[1], device="cpu", **kw)
    state = eng.init(0)
    eng.load_params(state, T.params_from_numpy(init, "cpu"))
    return eng, state


def _run(eng, state, batches):
    return [float(eng.step(state, b)[1]) for b in batches]


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_offload_is_bitwise_and_matches_jax(jax_runs, opt):
    init, jl, final, rms = jax_runs[opt]
    batches = _batches(STEPS)
    eng, state = _engine(opt, init)
    want = _run(eng, state, batches)
    wopt = eng.gather_opt_state(state)
    np.testing.assert_allclose(want, jl, rtol=1e-4)
    for w in (1, 2, 4):
        oeng, ost = _engine(opt, init, offload_opt_state=True,
                            offload_prefetch=w)
        assert oeng.describe().endswith(
            ", opt state offloaded=pinned_host)")
        rest = {n: dict(s) for n, s in ost.opt_state["state"].items()}
        got = _run(oeng, ost, batches)
        assert got == want, w
        np.testing.assert_allclose(got, jl, rtol=1e-4)
        for n, p in ost.params.items():
            assert torch.equal(p, state.params[n]), (w, n)
        gopt = oeng.gather_opt_state(ost)
        _held_to_jax(ost.params, gopt, final, rms, opt)
        assert gopt["step"] == wopt["step"] == STEPS
        for n, slots in ost.opt_state["state"].items():
            assert slots.keys() == wopt["state"][n].keys()
            for k, t in slots.items():
                assert t is rest[n][k], (w, n, k)  # updated where it rests
                assert torch.equal(t, wopt["state"][n][k]), (w, n, k)
                assert torch.equal(gopt["state"][n][k], t), (w, n, k)


class _OwnUpdate(T.AdamW):
    def update(self, params, grads, opt_state):
        return super().update(params, grads, opt_state)


def test_refusals_match_jax():
    """JAX's checks and messages: the window below 1 (offload on or
    off), and an optimizer whose update() is its own."""
    class JOwnUpdate(J.AdamW):
        def update(self, params, grads, opt_state):
            return super().update(params, grads, opt_state)

    mesh = J.make_mesh(devices=[jax.devices()[0]])
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    for jkw, pkw, jopt, popt in (
            (dict(offload_prefetch=0), dict(offload_prefetch=0),
             J.AdamW(), T.AdamW()),
            (dict(offload_opt_state=True), dict(offload_opt_state=True),
             JOwnUpdate(), _OwnUpdate())):
        _OwnUpdate.__name__ = JOwnUpdate.__name__ = "OwnUpdate"
        with pytest.raises(ValueError) as want:
            J.SingleDevice(JGPT2(JP["tiny"]), jopt, mesh=mesh, **jkw)
        with pytest.raises(ValueError) as got:
            T.SingleDevice(pm, popt, device="cpu", **pkw)
        assert str(got.value) == str(want.value)


def test_skipped_step_streams_nothing():
    """An overflowing dynamic-scale step under offload: nothing changes
    but the halved scale; the next step trains as the unoffloaded
    engine does."""
    init = {n: p.detach().numpy().copy() for n, p in T.GPT2Model(
        T.GPT2_PRESETS["tiny"], device="cpu").init(
        torch.Generator().manual_seed(0)).param_dict().items()}
    init["lm_head.w"] *= 10
    runs = []
    for kw in ({}, dict(offload_opt_state=True, offload_prefetch=1)):
        eng, state = _engine("adamw", init, loss_scale="dynamic", **kw)
        state.scaler = {"scale": 2.0 ** 127, "good": 0}
        before = {n: p.detach().clone() for n, p in state.params.items()}
        batches = _batches(2)
        eng.step(state, batches[0])
        assert state.opt_state["step"] == 0
        assert state.scaler == {"scale": 2.0 ** 126, "good": 0}
        assert all(torch.equal(p, before[n])
                   for n, p in state.params.items())
        assert all(not t.any() for s in state.opt_state["state"].values()
                   for t in s.values())
        loss = float(eng.step(state, batches[1])[1])
        runs.append((loss, eng.gather_params(state)))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(runs[1][1][n], p), n


def test_resume_under_offload_is_bitwise(tmp_path, jax_runs):
    init = jax_runs["adamw"][0]
    batches = _batches(6)
    kw = dict(offload_opt_state=True, offload_prefetch=2)
    eng, state = _engine("adamw", init, **kw)
    want = _run(eng, state, batches)
    wopt = eng.gather_opt_state(state)
    eng, state = _engine("adamw", init, **kw)
    got = _run(eng, state, batches[:3])
    ck.save_checkpoint(tmp_path, state, 3)
    eng = T.SingleDevice(T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu"),
                         _opts("adamw")[1], device="cpu", **kw)
    state = ck.load_checkpoint(tmp_path, eng)
    for s in state.opt_state["state"].values():
        for t in s.values():  # restored into fresh host tensors
            assert t.device.type == "cpu" and not t.requires_grad
    got += _run(eng, state, batches[3:])
    assert got == want
    gopt = eng.gather_opt_state(state)
    for n, slots in wopt["state"].items():
        for k, t in slots.items():
            assert torch.equal(gopt["state"][n][k], t), (n, k)
