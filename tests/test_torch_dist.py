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
import functools
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


def multi_engine_worker(rank, world, store, out_dir, configs):
    """One gloo rank running each configuration in turn (one spawn
    serving several checks): the `name` engine steps over the global
    batches from the weights in params{tag}.npz (or params{params}.npz);
    rank 0 saves the losses, params, optimizer state and scaler to
    result{tag}.pt.  A
    configuration's `hook` (fn, args), when given, is called as
    fn(rank, out_dir, tag, *args) before the engine is built; what it
    returns, if callable, after the run."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        for c in configs:
            _run_config(rank, out_dir, **c)
            # every rank done before any tears its groups down: gloo
            # aborted a rank now and then (exit -6) on a teardown race
            # under hpZ's subgroups
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _telemetry(mode, cls):
    """`cls` (JAX's Telemetry or the port's) for a case's `telemetry`
    ("on" / "layers"), with a tracer that never runs; None for None."""
    if mode is None:
        return None
    return cls(layers=mode == "layers", tracer=(lambda p: None,
                                                lambda: None))


def _run_config(rank, out_dir, name, sp, kw, opt, accum, overflow,
                model_kw=None, preset="tiny", tag="", hook=None,
                steps=STEPS, params=None, telemetry=None):
    done = hook[0](rank, out_dir, tag, *hook[1]) if hook else None
    model = T.build_model(dataclasses.replace(T.ALL_PRESETS[preset],
                                              **(model_kw or {})),
                          device="cpu")
    telem = _telemetry(telemetry, T.Telemetry)
    if telem is not None:
        kw = dict(kw, telemetry=telem)
    engine = getattr(T, name)(model, _optimizer(opt), device="cpu",
                              seq_parallel=sp, accum_steps=accum, **kw)
    state = engine.init(0)
    ref = np.load(os.path.join(
        out_dir, f"params{tag if params is None else params}.npz"))
    engine.load_params(state, T.params_from_numpy(dict(ref), "cpu"))
    if overflow:
        _overflow(state, state.params)
    losses, health = [], []
    for batch in _batches(steps if not overflow else 4, accum):
        state, loss = engine.step(state, batch)
        losses.append(float(loss))
        if telem is not None:
            mat = telem.layer_health()
            health.append((telem.poll(), None if mat is None
                           else torch.from_numpy(mat)))
    params = engine.gather_params(state)
    opt_state = engine.gather_opt_state(state)
    eval_loss = float(engine.eval_loss(state, _batches(1)[0]))
    if callable(done):
        done()
    if rank == 0:
        torch.save({"losses": losses, "params": params,
                    "opt": opt_state, "scaler": state.scaler,
                    "rank_map": engine.rank_map, "eval": eval_loss,
                    "lowering": engine._schedule.lowering,
                    "health": health},
                   os.path.join(out_dir, f"result{tag}.pt"))


def _jax_run(name, dp, sp, kw, opt, accum, overflow, model_kw=None,
             preset="tiny", telemetry=None):
    """The JAX engine on a (data[, seq]) CPU mesh: (params at init,
    losses, final state, engine, eval loss, and under AdamW each
    element's least bias-corrected gradient RMS over the steps).  With
    `telemetry` the engine's `health_log` holds each step's (health
    dict, layer matrix or None)."""
    import jax
    import jax.numpy as jnp
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    # the engine's own axis order, an axis of size 1 left out (JAX
    # :468-476); a tensor / expert split comes in `kw`, as the port's
    shape, names = [dp], ["data"]
    for ax, n in (("seq", sp), ("model", kw.get("tensor_parallel", 1)),
                  ("expert", kw.get("expert_parallel", 1))):
        if n > 1:
            shape.append(n)
            names.append(ax)
    mesh = J.make_mesh(tuple(shape), tuple(names),
                       devices=jax.devices()[:int(np.prod(shape))])
    jopt = (J.SGD(lr=1e-2, momentum=0.9, weight_decay=0.1) if opt == "sgd"
            else J.AdamW(lr=LR, weight_decay=0.1))
    jcfg = dataclasses.replace(JP[preset], **(model_kw or {}))
    from tiny_deepspeed_tpu.telemetry import Telemetry as JTelemetry
    telem = _telemetry(telemetry, JTelemetry)
    jeng = getattr(J, name)(jbuild(jcfg), jopt, mesh=mesh,
                            accum_steps=accum, telemetry=telem, **kw)
    jeng.health_log = []
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
        if telem is not None:
            jeng.health_log.append((telem.poll(), telem.layer_health()))
        if opt == "adamw" and not overflow:
            t = int(state.opt_state["step"])
            for n in rms:
                v = np.asarray(state.opt_state["state"][n]["v"])
                rms[n] = np.minimum(rms[n], np.sqrt(v / (1 - jopt.b2 ** t)))
    x, y = _batches(1)[0]
    ev = float(jeng.eval_loss(state, (jnp.asarray(x), jnp.asarray(y))))
    return init, np.asarray(losses), state, jeng, ev, rms


def check_against_jax(tmp_path, name, dp, sp, kw=None, opt="adamw",
                      accum=1, overflow=False, model_kw=None, atol=1e-5,
                      preset="tiny", progress=True):
    """Run `name` on the port over dp x sp gloo ranks and on JAX over a
    CPU mesh of that layout, the `preset` (of either family; default
    GPT-2's tiny) with `model_kw` replaced in both; compare as the module
    docstring says (params and optimizer state to `atol`).  The loss must
    fall over the steps — unless `progress` is False, which is allowed
    only where JAX's own loss does not fall (the random tokens sit near
    ln(vocab) from the start).  Returns (the port's result, JAX's state,
    engine, losses and least gradient RMS per element)."""
    runs = run_cases(tmp_path, {"": dict(
        name=name, dp=dp, sp=sp, kw=kw or {}, opt=opt, accum=accum,
        overflow=overflow, model_kw=model_kw, preset=preset)})
    return check_case(runs, "", atol, progress)


def run_cases(tmp_path, cases):
    """Each case — {id: check_against_jax's arguments as a dict: name, dp,
    sp and any of kw, opt, accum, overflow, model_kw, preset, and
    `telemetry` ("on" / "layers": each side's Telemetry, its per-step
    health kept) } — on JAX,
    then every case of one world size in one gloo spawn
    (`multi_engine_worker`): {id: (the port's result, JAX's run, the
    case)}.  A module-scoped fixture over it serves each case's test.
    A spawn that fails fails only its own cases: their entry holds the
    error, which `check_case` raises."""
    runs, by_world = {}, {}
    for cid, c in cases.items():
        c = dict(dict(kw={}, opt="adamw", accum=1, overflow=False,
                      model_kw=None, preset="tiny", telemetry=None), **c)
        out = _jax_run(c["name"], c["dp"], c["sp"], c["kw"], c["opt"],
                       c["accum"], c["overflow"], c["model_kw"],
                       c["preset"], c["telemetry"])
        np.savez(tmp_path / f"params{cid}.npz", **out[0])
        by_world.setdefault(_world(c), []).append(dict(
            name=c["name"], sp=c["sp"], kw=c["kw"], opt=c["opt"],
            accum=c["accum"], overflow=c["overflow"],
            model_kw=c["model_kw"], preset=c["preset"], tag=cid,
            telemetry=c["telemetry"]))
        runs[cid] = (out, c)
    failed = {}
    for world, configs in by_world.items():
        try:
            spawn(multi_engine_worker, world, tmp_path, configs,
                  timeout=120 + 60 * len(configs))
        except AssertionError as e:
            failed[world] = e
    return {cid: (failed.get(_world(c))
                  or torch.load(tmp_path / f"result{cid}.pt"), out, c)
            for cid, (out, c) in runs.items()}


def _world(c):
    """A case's rank count: data x seq x its tensor and expert splits."""
    kw = c["kw"]
    return (c["dp"] * c["sp"] * kw.get("tensor_parallel", 1)
            * kw.get("expert_parallel", 1))


def check_case(runs, cid, atol=1e-5, progress=True):
    """`check_against_jax`'s comparison of case `cid` of `run_cases`."""
    res, out, c = runs[cid]
    if isinstance(res, AssertionError):
        raise res
    return compare_with_jax(res, out, c["dp"], c["opt"], c["overflow"],
                            atol, progress)


def check_health(res, jeng, mode, n_layer, steps=STEPS):
    """A telemetry case's health, each step's port dict (and, in layers
    mode, its (n_layer, 6) matrix) within 1e-5 relative of JAX's engine's
    (`_jax_run`'s `health_log`)."""
    assert len(res["health"]) == len(jeng.health_log) == steps
    for i, ((th, tm), (jh, jm)) in enumerate(zip(res["health"],
                                                  jeng.health_log)):
        assert set(th) == set(jh)
        for k in jh:
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        if mode == "on":
            assert tm is None and jm is None
            continue
        assert tm.shape == jm.shape == (n_layer, 6)
        np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-5, atol=1e-7,
                                   err_msg=f"step {i}")


def compare_with_jax(res, jax_out, dp, opt="adamw", overflow=False,
                     atol=1e-5, progress=True):
    """`check_against_jax`'s comparison of a port result (what
    `multi_engine_worker` saves) with `_jax_run`'s output."""
    from tiny_deepspeed_tpu.parallel.partition import partition_tensors
    _, jl, jstate, jeng, jev, rms = jax_out
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
    assert tl[-1] < tl[0] if progress else jl[-1] >= jl[0]
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
            np.testing.assert_allclose(got[keep], want[keep], atol=atol,
                                       err_msg=f"{n}.{k}")
    assert held >= 0.99 * sum(p.numel() for p in res["params"].values())
    return res, jstate, jeng, jl, rms


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    """DDP, Zero1 and Zero2 at data 2: one gloo spawn runs all three."""
    return run_cases(tmp_path_factory.mktemp("data2"), {
        n: dict(name=n, dp=2, sp=1) for n in ("DDP", "Zero1", "Zero2")})


@pytest.mark.parametrize("name", ["DDP", "Zero1", "Zero2"])
def test_engine_matches_jax_data2(data2, name):
    check_case(data2, name)


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


@functools.lru_cache(maxsize=None)
def _single_device_run(accum):
    """SingleDevice's 3 steps, the world-1 cases' reference: run once a
    module for each accum."""
    return _run_engine(T.SingleDevice, _batches(3, accum),
                       accum_steps=accum)


@pytest.mark.parametrize("name", ["DDP", "Zero1", "Zero2"])
@pytest.mark.parametrize("accum", [1, 2])
def test_world1_engine_equals_single_device(world1, name, accum):
    """At world 1, AVG over one rank and a one-shard update change
    nothing: losses, params and moments bit for bit."""
    want = _single_device_run(accum)
    got = _run_engine(getattr(T, name), _batches(3, accum),
                      accum_steps=accum)
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
    """The knob still refused (pipeline parallelism) names ROADMAP.md; a
    tensor or expert split that the given context does not carry is
    refused; of the schedule's, Zero2 at data 2 builds the bucket
    lowering (and, with `grad_comm`, the quantized "quant_mono" one) and
    refuses the gather slot as JAX does (it needs ZeRO-3); the telemetry
    and the offload build, and `describe()` names them."""
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    if "telemetry" in knob or "offload_opt_state" in knob:
        eng = T.Zero2(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                      **knob)
        assert eng._schedule.lowering == "plain"
        assert eng.describe().endswith(
            ", telemetry=on)" if "telemetry" in knob
            else ", opt state offloaded=pinned_host)")
        return
    if "grad_comm" in knob:
        eng = T.Zero2(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                      **knob)
        assert eng._schedule.lowering == "quant_mono"
        assert "sched=grad_buckets=1,grad_comm=int8@quant_mono" in \
            eng.describe()
        return
    if "grad_buckets" in knob:
        eng = T.Zero2(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                      **knob)
        assert eng._schedule.lowering == "bucket"
        assert "sched=grad_buckets=2,grad_comm=fp32@bucket" in \
            eng.describe()
        return
    if "gather_prefetch" in knob or "hpz" in knob:
        with pytest.raises(ValueError, match="requires ZeRO-3"):
            T.Zero2(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(), **knob)
        return
    if "pipeline_parallel" not in knob:
        with pytest.raises(ValueError, match="disagrees with the given pctx"):
            T.Zero2(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(), **knob)
        return
    with pytest.raises(ValueError, match="slice 25.*ROADMAP.md"):
        T.Zero2(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(), **knob)


def test_refused_configurations_raise(world1):
    """ZeRO-3's gather slot at world 1 is inert, with JAX's warning: the
    on-demand path, bit for bit; the other configurations raise."""
    batches = _batches(2)
    want = _run_engine(Zero3, batches)
    for knob in (dict(gather_prefetch=2), dict(hpz=True)):
        with pytest.warns(UserWarning, match="gather slot.*inert"):
            got = _run_engine(Zero3, batches, **knob)
        assert got[0] == want[0]
        for n, p in want[1].items():
            assert torch.equal(got[1][n], p), n
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    # Ulysses builds (inert without a seq split, as in JAX)
    eng = T.DDP(pm, T.AdamW(), device="cpu", seq_impl="ulysses")
    assert eng.pctx.seq_impl == "ulysses" and eng.pctx.seq_comm is None
    with pytest.raises(ValueError, match="divide"):
        T.DDP(pm, T.AdamW(), device="cpu", seq_parallel=2)
    # dropout on two ranks builds, and rank 1 draws its rows of the
    # global batch's mask
    drop = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                           dropout=0.1), device="cpu")
    eng = T.Zero1(drop, T.AdamW(), device="cpu", pctx=_fake_pctx())
    rank1 = dataclasses.replace(eng.pctx, rank=1, data_rank=1)
    x = torch.ones(2, 8, 4)
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    whole = gpt2_mod._dropout(torch.ones(4, 8, 4), 5, 0.1)
    assert torch.equal(gpt2_mod._dropout(x, 5, 0.1, eng.pctx), whole[:2])
    assert torch.equal(gpt2_mod._dropout(x, 5, 0.1, rank1), whole[2:])
