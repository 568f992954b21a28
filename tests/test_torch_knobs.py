# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's training knobs against the JAX package, on the CPU: the
fused and chunked lm_head + loss heads, the fused AdamW update and
dropout.

Pinned here:

- the plain versions of the fused xent kernels (forward, dx, dW) equal
  the JAX Pallas kernels (`xent_pallas._fwd` / `_bwd`, interpret mode)
  within 1e-5, and `_adamw_update_plain` equals `adamw_update_pallas`
  within 1e-6;
- `FusedXentFn`'s gradients equal `jax.grad` of JAX `pallas_fused_xent`
  and pass `torch.autograd.gradcheck` in f64; the chunked
  `fused_linear_xent` equals JAX's, the one-chunk fallback included;
- whole-model loss and gradients with the "pallas" and "chunked" heads
  (tied and untied) equal `jax.value_and_grad(GPT2Model.apply)` within
  rtol 1e-4 — the JAX "pallas" head both as the CPU routes it (chunked)
  and through its kernels (TPU gate forced, interpret mode);
- dropout with JAX's own masks patched in equals JAX's loss and
  gradients with the same rng (sites, scaling and key tree); without the
  patch, its keep share, key stream, remat invariance and eval;
- 20-step `SingleDevice` trajectories with the fused head and
  `AdamW(fused=True)` equal JAX's within 1e-4 relative, also with grad
  clipping, `accum_steps=2` and an lr schedule;
- refusals, and the `--fused-xent` / `--dropout` CLI flags.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu import AdamW as JAdamW
from tiny_deepspeed_tpu import SingleDevice as JSingleDevice
from tiny_deepspeed_tpu import make_mesh
from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from tiny_deepspeed_tpu.ops import flash_fa2 as jflash
from tiny_deepspeed_tpu.ops import layernorm_pallas as jln
from tiny_deepspeed_tpu.ops import softmax_xent as jsx
from tiny_deepspeed_tpu.ops import xent_pallas as jxp
from tiny_deepspeed_tpu.ops.dispatch import kernel_target_forced
from tiny_deepspeed_tpu.optim import adamw_pallas as jap
from tiny_deepspeed_tpu.optim import schedule as jsched
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch import rng as prng
from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
from tiny_deepspeed_tpu_torch.ops import fused_xent as fx
from tiny_deepspeed_tpu_torch.ops import softmax_xent as tsx
from tiny_deepspeed_tpu_torch.optim import adamw_fused as af
from tiny_deepspeed_tpu_torch.optim import schedule as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def interpret(monkeypatch):
    """Every JAX Pallas kernel in interpret mode (the CPU has no Mosaic)."""
    monkeypatch.setattr(jxp, "_INTERPRET", True)
    monkeypatch.setattr(jap, "INTERPRET", True)
    monkeypatch.setattr(jflash, "_INTERPRET", True)
    monkeypatch.setattr(jln, "INTERPRET", True)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _xent_data(s, d, v, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.05).astype(np.float32)
    t = rng.integers(0, v, s).astype(np.int32)
    if dtype == "bf16":
        jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        tx = torch.from_numpy(x).bfloat16()
        tw = torch.from_numpy(w).bfloat16()
    else:
        jx, jw = jnp.asarray(x), jnp.asarray(w)
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    return (jx, jw, jnp.asarray(t)), (tx, tw, torch.from_numpy(t))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


# -- the kernels' plain versions against the Pallas kernels ------------------

XENT_CASES = {
    "vocab_tail": (64, 64, 704, np.float32),   # 704 = 5.5 x the 128 tile
    "odd_s": (40, 32, 256, np.float32),        # no 8-aligned token block
    "bf16": (64, 64, 512, "bf16"),
}


@pytest.mark.parametrize("case", sorted(XENT_CASES))
@pytest.mark.parametrize("which", ["fwd", "dx", "dw"])
def test_xent_plain_matches_pallas(interpret, case, which):
    s, d, v, dt = XENT_CASES[case]
    (jx, jw, jt), (tx, tw, tt) = _xent_data(s, d, v, dt)
    bs = jxp._pick_bs(s)
    jloss, jlse = jxp._fwd(jx, jw, jt, bs=bs, bv=128)
    loss, lse = fx._xent_fwd_plain(tx, tw, tt)
    if which == "fwd":
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0],
                                   rtol=1e-5, atol=1e-5)
        return
    gs = np.float32(0.7 / s)
    jdx, jdw = jxp._bwd(jx, jw, jt, jlse, jnp.asarray(gs), bs=bs,
                        bv_dx=128, bv_dw=128)
    if which == "dx":
        got = fx._xent_dx_plain(tx, tw, tt, lse, torch.tensor(gs))
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_f32(got), _f32(jdx), atol=1e-5)
    else:
        got = fx._xent_dw_plain(tx, tw, tt, lse, torch.tensor(gs))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jdw), atol=1e-5)


@pytest.mark.parametrize("n,kw", [
    (9000, dict()), (9000, dict(decoupled=True)),
    (9000, dict(maximize=True)), (20000, dict(decoupled=True, wd=0.0)),
    (8192 * 3, dict(maximize=True, decoupled=True)),
], ids=["l2", "decoupled", "maximize", "no_wd", "max_decoupled"])
def test_adamw_plain_matches_pallas(interpret, n, kw):
    kw = dict(dict(wd=0.1, decoupled=False, maximize=False), **kw)
    rng = np.random.default_rng(n)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 0.1).astype(np.float32)
    m = (rng.standard_normal(n) * 0.01).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    b1, b2, step = 0.9, 0.999, 7
    jp, jm, jv = jap.adamw_update_pallas(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(step, jnp.int32), lr=3e-3, b1=b1, b2=b2, eps=1e-8, **kw)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    af._adamw_update_plain(tp, torch.from_numpy(g), tm, tv, lr=3e-3,
                           c1=1 - b1 ** step, c2=1 - b2 ** step, b1=b1,
                           b2=b2, eps=1e-8, **kw)
    for got, ref in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


# -- the autograd Functions ---------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 24, 64), (40, 64)],
                         ids=["btd", "sd"])
def test_fused_xent_fn_grads_match_jax(interpret, shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((64, 300)) * 0.05).astype(np.float32)
    t = rng.integers(0, 300, shape[:-1]).astype(np.int32)
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: 3.0 * jxp.pallas_fused_xent(a, b, jnp.asarray(t)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = 3.0 * fx.pallas_fused_xent(tx, tw, torch.from_numpy(t))
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **GRAD_TOL)


def test_fused_xent_fn_gradcheck_f64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 32, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = (torch.randn(32, 37, generator=g, dtype=torch.float64) * 0.1
         ).requires_grad_()
    t = torch.randint(0, 37, (2, 5), generator=g)
    assert torch.autograd.gradcheck(
        lambda a, b: fx.pallas_fused_xent(a, b, t), (x, w))


@pytest.mark.parametrize("t_len", [256, 131], ids=["chunk128", "one_chunk"])
def test_chunked_head_matches_jax(t_len):
    rng = np.random.default_rng(t_len)
    x = rng.standard_normal((2, t_len, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 200)) * 0.05).astype(np.float32)
    t = rng.integers(0, 200, (2, t_len)).astype(np.int32)
    if t_len == 131:  # prime: no chunk divisor in [32, 128]
        with pytest.warns(UserWarning, match="no chunk divisor"):
            assert tsx._pick_chunk(t_len, 128) == t_len
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: jsx.fused_linear_xent(a, b, jnp.asarray(t)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = tsx.fused_linear_xent(tx, tw, torch.from_numpy(t))
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **GRAD_TOL)


# -- the whole model ----------------------------------------------------------

def _pair(**overrides):
    jm = JaxGPT2(dataclasses.replace(JAX_PRESETS["tiny"], **overrides))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                         **overrides), device="cpu")
    pm.load_state_dict(T.params_from_numpy(_np(jp), "cpu"))
    return jm, jp, pm


def _batch(b=2, t=64, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, t)), rng.integers(0, vocab, (b, t))


def _port_loss_grads(pm, idx, tgt, rng=None):
    loss = pm.apply(torch.from_numpy(idx), torch.from_numpy(tgt), rng=rng)
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    return float(loss.detach()), {n: g for (n, _), g in
                                  zip(pm.named_parameters(), grads)}


def _assert_matches(loss, grads, jl, jg):
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), err_msg=n,
                                   **GRAD_TOL)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_model_fused_heads_match_jax(impl, tie):
    """JAX on the CPU routes "pallas" to its chunked head."""
    jm, jp, pm = _pair(fused_xent=True, fused_xent_impl=impl,
                       tie_weights=tie)
    assert T.effective_xent_impl(pm.config) == impl
    idx, tgt = _batch()
    jl, jg = jax.value_and_grad(jm.apply)(jp, jnp.asarray(idx),
                                          jnp.asarray(tgt))
    _assert_matches(*_port_loss_grads(pm, idx, tgt), jl, jg)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_model_pallas_head_matches_jax_kernels(interpret, tie):
    """The JAX "pallas" head through its Pallas kernels (TPU gate forced,
    every kernel in interpret mode)."""
    jm, jp, pm = _pair(fused_xent=True, fused_xent_impl="pallas",
                       tie_weights=tie)
    idx, tgt = _batch(t=64, seed=1)
    with kernel_target_forced("tpu"):
        jl, jg = jax.value_and_grad(jm.apply)(jp, jnp.asarray(idx),
                                              jnp.asarray(tgt))
    _assert_matches(*_port_loss_grads(pm, idx, tgt), jl, jg)


# -- dropout ------------------------------------------------------------------

def _jax_masks(monkeypatch, rng, jkey, n_layer, keep=0.9):
    """Patch the port's mask draw to return JAX's masks for the same
    places: the embedding's from keys[0], layer l site s from
    fold_in(keys[l + 1], s), as JAX's `_dropout_setup` and `_block` draw
    them — keyed by the port's key for that place."""
    pkeys = prng.split(rng, n_layer + 1)
    jkeys = jax.random.split(jkey, n_layer + 1)
    table = {pkeys[0]: jkeys[0]}
    for l in range(n_layer):
        for site in (0, 1):
            table[prng.fold_in(pkeys[l + 1], site)] = jax.random.fold_in(
                jkeys[l + 1], site)
    seen = []

    def keep_mask(key, shape, keep_, device):
        assert keep_ == keep
        seen.append(key)
        return torch.from_numpy(np.asarray(
            jax.random.bernoulli(table[key], keep_, tuple(shape))))

    monkeypatch.setattr(gpt2_mod, "_dropout_keep", keep_mask)
    return seen


@pytest.mark.parametrize("overrides", [
    {}, dict(fused_xent=True, fused_xent_impl="pallas"),
    dict(remat_policy="nothing"),
], ids=["default", "pallas_head", "remat_nothing"])
def test_dropout_with_jax_masks_matches_jax(monkeypatch, overrides):
    jm, jp, pm = _pair(dropout=0.1, **overrides)
    idx, tgt = _batch(seed=2)
    jkey = jax.random.PRNGKey(11)
    seen = _jax_masks(monkeypatch, 12345, jkey, pm.config.n_layer)
    jl, jg = jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(idx), jnp.asarray(tgt),
                           rng=jkey))(jp)
    loss, grads = _port_loss_grads(pm, idx, tgt, rng=12345)
    # embedding + 2 sites per layer, each redrawn by its block's recompute
    assert len(set(seen)) == 1 + 2 * pm.config.n_layer
    _assert_matches(loss, grads, jl, jg)
    # without rng: no dropout, JAX's eval loss
    with torch.no_grad():
        ev = float(pm.apply(torch.from_numpy(idx), torch.from_numpy(tgt)))
    np.testing.assert_allclose(
        ev, float(jm.apply(jp, jnp.asarray(idx), jnp.asarray(tgt))),
        rtol=1e-5)


def test_dropout_keep_share_and_scaling():
    x = torch.ones(1000, 1000)
    y = gpt2_mod._dropout(x, 99, 0.1)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) <= 4 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))


def test_dropout_keys_differ_and_repeat():
    keys = prng.split(5, 3)
    assert len(set(keys)) == 3
    places = {prng.fold_in(k, s) for k in keys for s in (0, 1)}
    steps = {prng.fold_in(prng.fold_in(5, 0xD0), n) for n in range(4)}
    assert len(places) == 6 and len(steps) == 4
    masks = [gpt2_mod._dropout_keep(k, (64,), 0.9, "cpu")
             for k in sorted(places)]
    assert all(not torch.equal(a, b) for i, a in enumerate(masks)
               for b in masks[i + 1:])
    k = sorted(places)[0]
    assert torch.equal(gpt2_mod._dropout_keep(k, (64,), 0.9, "cpu"),
                       masks[0])


def test_dropout_remat_policies_give_identical_grads():
    idx, tgt = _batch(t=48, seed=4)
    ref = None
    for remat, policy in ((False, "dots_no_batch"), (True, "nothing"),
                          (True, "dots_no_batch")):
        _, _, pm = _pair(dropout=0.1, remat=remat, remat_policy=policy)
        loss, grads = _port_loss_grads(pm, idx, tgt, rng=77)
        if ref is None:
            ref = (loss, grads)
            continue
        assert loss == ref[0]
        for n, g in grads.items():
            assert torch.equal(g, ref[1][n]), (policy, n)


def _port_engine(cfg=None, **engine_kw):
    pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                         **(cfg or {})), device="cpu")
    eng = T.SingleDevice(pm, T.AdamW(lr=1e-3, weight_decay=0.1),
                         device="cpu", **engine_kw)
    return eng, eng.init(0)


def test_dropout_engine_stream_and_eval():
    batches = _batches(3)
    runs = []
    for _ in range(2):
        eng, state = _port_engine(dict(dropout=0.1))
        assert state.dropout_base == prng.fold_in(0, 0xD0)
        runs.append([float(eng.step(state, b)[1]) for b in batches])
    assert runs[0] == runs[1]
    # eval drops nothing: twice the same, and the dropout-free model's
    e1, e2 = (float(eng.eval_loss(state, batches[0])) for _ in range(2))
    plain, pstate = _port_engine()
    assert pstate.dropout_base is None
    plain.model.load_state_dict(eng.model.state_dict())
    assert e1 == e2 == float(plain.eval_loss(pstate, batches[0]))
    # a training step draws masks: its loss differs from eval's
    assert float(eng.step(state, batches[0])[1]) != e1


# -- SingleDevice trajectories ------------------------------------------------

def _batches(n, accum=1, b=2, t=32):
    loader = T.TokenLoader(None, b * accum, t, vocab_size=512, seed=3)
    out = []
    for _ in range(n):
        x, y = loader.next()
        if accum > 1:
            x, y = x.reshape(accum, b, t), y.reshape(accum, b, t)
        out.append((x, y))
    return out


KNOBBED = dict(fused_xent=True, fused_xent_impl="pallas")


def _engines(schedule=False, **engine_kw):
    """(jax engine, state, port engine, state): the knobbed tiny preset,
    AdamW(fused=True, wd=0.1) on both (JAX's falls back to its XLA
    update on the 8-device CPU host, with a warning: the kernel's math),
    lr 1e-3 or a warmup-cosine schedule peaking at 3e-3."""
    jlr, tlr = 1e-3, 1e-3
    if schedule:
        jlr = jsched.warmup_cosine(3e-3, 5, warmup_steps=2)
        tlr = tsched.warmup_cosine(3e-3, 5, warmup_steps=2)
    jm = JaxGPT2(dataclasses.replace(JAX_PRESETS["tiny"], **KNOBBED))
    jeng = JSingleDevice(
        jm, JAdamW(lr=jlr, weight_decay=0.1, fused=True),
        mesh=make_mesh(devices=[jax.devices()[0]]), **engine_kw)
    jstate = jeng.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **KNOBBED),
                     device="cpu")
    teng = T.SingleDevice(pm, T.AdamW(lr=tlr, weight_decay=0.1, fused=True),
                          device="cpu", **engine_kw)
    tstate = teng.init(0)
    pm.load_state_dict(T.params_from_numpy(_np(jstate.params), "cpu"))
    return jeng, jstate, teng, tstate


def _run(jeng, jstate, teng, tstate, batches):
    jl, tl = [], []
    for x, y in batches:
        jstate, loss = jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))
        tstate, loss = teng.step(tstate, (x, y))
        tl.append(float(loss))
    return np.asarray(jl), np.asarray(tl)


@pytest.mark.filterwarnings("ignore:AdamW\\(fused=True\\) falling back")
def test_knobbed_20_step_trajectory_matches_jax():
    jl, tl = _run(*_engines(), _batches(20))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@pytest.mark.filterwarnings("ignore:AdamW\\(fused=True\\) falling back")
@pytest.mark.parametrize("kw,accum", [
    (dict(grad_clip=0.5), 1), (dict(accum_steps=2), 2),
    (dict(schedule=True), 1),
], ids=["grad_clip", "accum2", "schedule"])
def test_knobbed_engine_knobs_match_jax(kw, accum):
    jl, tl = _run(*_engines(**kw), _batches(5, accum=accum))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


# -- refusals and the CLI -----------------------------------------------------

@pytest.mark.parametrize("make,exc", [
    (lambda: T.AdamW(fused=True, amsgrad=True), ValueError),
    (lambda: T.AdamW(fused=True, state_dtype=torch.bfloat16), ValueError),
    (lambda: T.AdamW(fused="auto"), NotImplementedError),
    (lambda: T.AdamW(fused=True).init({"w": torch.zeros(3).half()}),
     ValueError),
    (lambda: T.GPT2Model(dataclasses.replace(
        T.GPT2_PRESETS["tiny"], gather_quant="fp8"), device="cpu"),
     ValueError),
    (lambda: T.GPT2Model(dataclasses.replace(
        T.GPT2_PRESETS["tiny"], fused_xent=True, fused_xent_impl="fp8"),
        device="cpu"), ValueError),
], ids=["amsgrad", "bf16_state", "auto", "f16_param", "gather_quant",
        "bad_impl"])
def test_refusals(make, exc):
    with pytest.raises(exc):
        make()


@pytest.mark.parametrize("head", ["pallas", "chunked"])
def test_train_module_knobs_run_on_cpu(head):
    out = subprocess.run(
        [sys.executable, "-m", "tiny_deepspeed_tpu_torch.train",
         "--device", "cpu", "--model", "tiny", "--iters", "3",
         "--seq-len", "64", "--fused-xent", head, "--dropout", "0.1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    losses = [float(ln.split()[3]) for ln in lines if " loss " in ln]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert lines[-1].startswith("done: 3 iters in ")
