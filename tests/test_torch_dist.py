# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's DDP, ZeRO-1 and ZeRO-2 over gloo against the JAX engines,
on the CPU: world 2 (data 2).

The JAX package's `tiny` preset (f32) is initialised from a seed; its
weights cross to the port through numpy.  Each port engine runs on
spawned gloo processes (one per rank, a file:// store), every rank
stepping on the same global batches; the JAX engine of the same stage
runs on a CPU mesh of the same layout (`check_against_jax`, shared with
tests/test_torch_dist_seq.py and tests/test_torch_dist_knobs.py).
Pinned here:

- 10-step loss trajectories within 1e-4 relative of JAX's, and the
  gathered params and optimizer state after them at 1e-5.  Under AdamW
  that holds on every element whose gradient is not roundoff: Adam's
  normalized step m/sqrt(v) turns a 1e-7 roundoff of a gradient whose
  RMS is near zero (the key bias, whose gradient vanishes under the
  softmax's shift invariance; embedding rows no token has hit) into up to
  a whole step of lr.  So params, m and sqrt(v) (bias-corrected, the
  gradient's RMS: m's units) are compared where JAX's bias-corrected
  gradient RMS stayed at or above `RMS_FLOOR` at every step, and at least
  99% of the elements must be so.  Under SGD (tests/test_torch_dist_knobs.py)
  every element is held to 1e-5;
- `rank_map` equal to JAX's (`partition_tensors` over its param shapes);
- world-1 engines bit-equal to `SingleDevice`;
- refused knobs raise.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.parallel import Zero3
from tiny_deepspeed_tpu_torch.parallel.mesh import ParallelContext
from test_torch_ring import spawn

B, SEQ, STEPS = 4, 32, 10
LR = 1e-3
# 100x the gradients' roundoff (~1e-7): below it 1e-7 is 1% of Adam's
# normalized step, 1e-5 of a param after one step of LR
RMS_FLOOR = 1e-5


def _batches(n, accum=1):
    loader = T.TokenLoader(None, B * accum, SEQ, vocab_size=512, seed=3)
    out = []
    for _ in range(n):
        x, y = loader.next()
        if accum > 1:
            x, y = x.reshape(accum, B, SEQ), y.reshape(accum, B, SEQ)
        out.append((x, y))
    return out


def _optimizer(name):
    if name == "sgd":
        return T.SGD(lr=1e-2, momentum=0.9, weight_decay=0.1)
    return T.AdamW(lr=LR, weight_decay=0.1)


def _overflow(state, params):
    """The dynamic-scale overflow setup: scale 2^127 and a 40x lm_head
    make the first step's scaled gradients overflow f32 (the per-device
    shares of the global mean, at world 2)."""
    state.scaler = {"scale": 2.0 ** 127, "good": 0}
    with torch.no_grad():
        params["lm_head.w"].mul_(40)


def _engine_worker(rank, world, store, out_dir, name, sp, kw, opt, accum,
                   overflow):
    """One gloo rank: `name` engine steps over the global batches; rank 0
    saves the losses, params, optimizer state and scaler."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        model = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
        engine = getattr(T, name)(model, _optimizer(opt), device="cpu",
                                  seq_parallel=sp, accum_steps=accum, **kw)
        state = engine.init(0)
        ref = np.load(os.path.join(out_dir, "params.npz"))
        model.load_state_dict(T.params_from_numpy(dict(ref), "cpu"))
        if overflow:
            _overflow(state, state.params)
        losses = []
        for batch in _batches(STEPS if not overflow else 4, accum):
            state, loss = engine.step(state, batch)
            losses.append(float(loss))
        params = engine.gather_params(state)
        opt_state = engine.gather_opt_state(state)
        eval_loss = float(engine.eval_loss(state, _batches(1)[0]))
        if rank == 0:
            torch.save({"losses": losses, "params": params,
                        "opt": opt_state, "scaler": state.scaler,
                        "rank_map": engine.rank_map, "eval": eval_loss},
                       os.path.join(out_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


def _jax_run(name, dp, sp, kw, opt, accum, overflow):
    """The JAX engine on a (data[, seq]) CPU mesh: (params at init,
    losses, final state, engine, eval loss, and under AdamW each
    element's least bias-corrected gradient RMS over the steps)."""
    import jax
    import jax.numpy as jnp
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
    from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2
    shape, names = ((dp, sp), ("data", "seq")) if sp > 1 else ((dp,),
                                                               ("data",))
    mesh = J.make_mesh(shape, names, devices=jax.devices()[:dp * sp])
    jopt = (J.SGD(lr=1e-2, momentum=0.9, weight_decay=0.1) if opt == "sgd"
            else J.AdamW(lr=LR, weight_decay=0.1))
    jeng = getattr(J, name)(JGPT2(JP["tiny"]), jopt, mesh=mesh,
                            accum_steps=accum, **kw)
    state = jeng.init(jax.random.PRNGKey(0))
    init = {n: np.asarray(p) for n, p in state.params.items()}
    if overflow:
        state = state.replace(
            scaler={"scale": jnp.float32(2.0 ** 127),
                    "good": jnp.int32(0)},
            params=dict(state.params,
                        **{"lm_head.w": state.params["lm_head.w"] * 40}))
    losses, rms = [], {n: np.inf for n in init}
    for x, y in _batches(STEPS if not overflow else 4, accum):
        state, loss = jeng.step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(loss))
        if opt == "adamw" and not overflow:
            t = int(state.opt_state["step"])
            for n in rms:
                v = np.asarray(state.opt_state["state"][n]["v"])
                rms[n] = np.minimum(rms[n], np.sqrt(v / (1 - jopt.b2 ** t)))
    x, y = _batches(1)[0]
    ev = float(jeng.eval_loss(state, (jnp.asarray(x), jnp.asarray(y))))
    return init, np.asarray(losses), state, jeng, ev, rms


def check_against_jax(tmp_path, name, dp, sp, kw=None, opt="adamw",
                      accum=1, overflow=False):
    """Run `name` on the port over dp x sp gloo ranks and on JAX over a
    CPU mesh of that layout; compare as the module docstring says."""
    from tiny_deepspeed_tpu.parallel.partition import partition_tensors
    kw = kw or {}
    init, jl, jstate, jeng, jev, rms = _jax_run(name, dp, sp, kw, opt,
                                                accum, overflow)
    np.savez(tmp_path / "params.npz", **init)
    spawn(_engine_worker, dp * sp, tmp_path, name, sp, kw, opt, accum,
          overflow, timeout=180)
    res = torch.load(tmp_path / "result.pt")
    tl = np.asarray(res["losses"])
    assert res["rank_map"] == jeng.rank_map == partition_tensors(
        jeng.model.param_shapes(), dp)
    if overflow:
        # both skip the same steps (params, moments and counter kept,
        # the scale halved each time), then train on
        np.testing.assert_array_equal(np.isfinite(tl), np.isfinite(jl))
        fin = np.isfinite(jl)
        np.testing.assert_allclose(tl[fin], jl[fin], rtol=1e-4)
        assert res["scaler"]["scale"] == float(jstate.scaler["scale"]) \
            < 2.0 ** 127
        assert res["scaler"]["good"] == int(jstate.scaler["good"])
        assert 0 < res["opt"]["step"] == int(jstate.opt_state["step"]) < 4
        return
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(res["eval"], jev, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert res["opt"]["step"] == int(jstate.opt_state["step"]) == STEPS
    bc2 = 1 - jeng.optimizer.b2 ** STEPS if opt == "adamw" else None
    held = 0
    for n, p in res["params"].items():
        keep = np.broadcast_to(rms[n] >= RMS_FLOOR, p.shape)
        held += keep.sum()
        slots, jslots = res["opt"]["state"][n], jstate.opt_state["state"][n]
        assert set(slots) == set(jslots), n
        pairs = {"param": (p.numpy(), np.asarray(jstate.params[n]))}
        pairs.update({k: (t.numpy(), np.asarray(jslots[k]))
                      for k, t in slots.items()})
        if opt == "adamw":
            pairs["v"] = tuple(np.sqrt(x / bc2) for x in pairs["v"])
        for k, (got, want) in pairs.items():
            np.testing.assert_allclose(got[keep], want[keep], atol=1e-5,
                                       err_msg=f"{n}.{k}")
    assert held >= 0.99 * sum(p.numel() for p in res["params"].values())


@pytest.mark.parametrize("name", ["DDP", "Zero1", "Zero2"])
def test_engine_matches_jax_data2(tmp_path, name):
    check_against_jax(tmp_path, name, 2, 1)


@pytest.fixture
def world1():
    """A one-rank gloo group in this process."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _run_engine(cls, batches, **kw):
    model = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    engine = cls(model, T.AdamW(lr=LR, weight_decay=0.1), device="cpu",
                 **kw)
    state = engine.init(0)
    losses = [float(engine.step(state, b)[1]) for b in batches]
    return (losses, engine.gather_params(state),
            engine.gather_opt_state(state))


@pytest.mark.parametrize("name", ["DDP", "Zero1", "Zero2"])
@pytest.mark.parametrize("accum", [1, 2])
def test_world1_engine_equals_single_device(world1, name, accum):
    """At world 1, AVG over one rank and a one-shard update change
    nothing: losses, params and moments bit for bit."""
    batches = _batches(3, accum)
    want = _run_engine(T.SingleDevice, batches, accum_steps=accum)
    got = _run_engine(getattr(T, name), batches, accum_steps=accum)
    assert got[0] == want[0]
    for n, p in want[1].items():
        assert torch.equal(got[1][n], p), n
    assert got[2]["step"] == want[2]["step"] == 3
    for n, slots in want[2]["state"].items():
        for k, t in slots.items():
            assert torch.equal(got[2]["state"][n][k], t), (n, k)


@pytest.mark.parametrize("fused,impl,multi,seq,want", [
    (False, "chunked", False, False, "unfused"),
    (True, "chunked", True, False, "chunked"),
    (True, "pallas", False, False, "pallas"),
    (True, "pallas", True, False, "chunked"),
    (True, "pallas", True, True, "unfused"),
    (True, "chunked", False, True, "unfused")])
def test_effective_xent_impl_under_ranks(fused, impl, multi, seq, want):
    """JAX's predicate (gpt2.py:205-223): a sequence split runs the
    unfused head, more than one rank turns "pallas" into "chunked"."""
    cfg = dataclasses.replace(T.GPT2_PRESETS["tiny"], fused_xent=fused,
                              fused_xent_impl=impl)
    assert T.effective_xent_impl(cfg, multi_device=multi,
                                 seq_sharded=seq) == want


def _fake_pctx():
    """A two-rank context that no collective is ever run on (refusal
    checks)."""
    return ParallelContext(world=2, rank=0, data_size=2, seq_size=1,
                           data_rank=0, seq_rank=0)


@pytest.mark.parametrize("knob", [
    dict(telemetry=object()), dict(offload_opt_state=True),
    dict(grad_comm="int8"), dict(grad_buckets=2), dict(gather_prefetch=2),
    dict(hpz=True), dict(tensor_parallel=2), dict(expert_parallel=2),
    dict(pipeline_parallel=2)])
def test_refused_engine_knobs_raise(knob):
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        T.Zero2(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(), **knob)


def test_refused_configurations_raise(world1):
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    with pytest.raises(ValueError, match="ZeRO-3.*ROADMAP.md"):
        Zero3(pm, T.AdamW(), device="cpu")
    with pytest.raises(ValueError, match="Ulysses.*ROADMAP.md"):
        T.DDP(pm, T.AdamW(), device="cpu", seq_impl="ulysses")
    with pytest.raises(ValueError, match="divide"):
        T.DDP(pm, T.AdamW(), device="cpu", seq_parallel=2)
    drop = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                           dropout=0.1), device="cpu")
    with pytest.raises(ValueError, match="dropout.*ROADMAP.md"):
        T.Zero1(drop, T.AdamW(), device="cpu", pctx=_fake_pctx())
