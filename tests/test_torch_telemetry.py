# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The engine's telemetry knob against the JAX package, on the CPU:
the tiny preset in f32, weights crossing through numpy.

Pinned here:

- `telemetry.health`: `health_vector`, `layer_health_matrix` and
  `first_nonfinite_layer` equal JAX's on the same numpy inputs (1e-6);
- `Telemetry`'s step side: JAX's registry (a fake tracer) and the
  port's, fed the same step times (one clock patched into both) and the
  same health vectors and layer matrices, end with equal counters,
  gauges, flight-flush reasons and flushed JSONL records (minus `ts`),
  and every record validates under both schema modules;
- `SingleDevice(telemetry=...)`: 5 steps whose health dicts are within
  1e-5 relative of JAX's engine's, and whose losses are bit for bit the
  port's run without telemetry.  Under SGD every field; under AdamW
  every field but the update norm, which is held to 1e-4: Adam's
  normalized step m/sqrt(v) turns a 1e-7 roundoff of a gradient whose
  RMS is near zero into up to a whole step of lr (the rule of
  tests/test_torch_dist.py), and the update norm sums those elements
  (measured on the CPU: within 2e-5 over 5 steps, SGD's within 1e-7);
- layers mode (remat on, and `accum_steps=2`): the (n_layer, 6) matrix
  within 1e-5 relative of JAX's; a non-finite weight in one layer is
  named by `first_nonfinite_layer` as JAX names it; MoE refused with
  JAX's message, and the pipeline forward by the engines' refusal of
  pipeline parallelism, which the port does not have yet.

tests/test_torch_sched.py holds layers mode under Zero2 and the composed
lowering at data 2 over gloo.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu as J
from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2
from tiny_deepspeed_tpu.telemetry import health as JH
from tiny_deepspeed_tpu.telemetry import schema as JS
from tiny_deepspeed_tpu.telemetry.registry import Telemetry as JTelemetry
from tiny_deepspeed_tpu.utils.profiling import MetricsLogger as JLogger
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.parallel import schedule as S
from tiny_deepspeed_tpu_torch.telemetry import Telemetry
from tiny_deepspeed_tpu_torch.telemetry import health as H
from tiny_deepspeed_tpu_torch.telemetry import schema as PS
from tiny_deepspeed_tpu_torch.utils.profiling import MetricsLogger

REL = 1e-5


def _trees(rng, nonfinite=False):
    shapes = {"wte": (16, 8), "h.w": (3, 8, 4), "h.b": (3, 4), "ln.w": (8,)}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    q = {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    if nonfinite:
        g["h.w"][1, 2, 3] = np.nan
        g["wte"][0, 0] = np.inf
    return g, p, q


@pytest.mark.parametrize("nonfinite", [False, True])
def test_health_functions_match_jax(nonfinite):
    rng = np.random.default_rng(7)
    g, p, q = _trees(rng, nonfinite)
    t = {k: {n: torch.from_numpy(v) for n, v in d.items()}
         for k, d in (("g", g), ("p", p), ("q", q))}
    jv = np.asarray(JH.health_vector(jnp.float32(2.5),
                                     {k: jnp.asarray(v) for k, v in g.items()},
                                     {k: jnp.asarray(v) for k, v in p.items()},
                                     {k: jnp.asarray(v) for k, v in q.items()}))
    tv = H.health_vector(2.5, t["g"], t["p"], t["q"]).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    th, jh = H.health_dict(tv), JH.health_dict(jv)
    assert list(th) == list(jh) == list(H.HEALTH_FIELDS)
    assert th["nonfinite_grads"] == jh["nonfinite_grads"] == 2 * nonfinite
    probe = np.abs(rng.standard_normal((3, 4))).astype(np.float32)
    probe[:, 1] = probe[:, 3] = 0
    if nonfinite:
        probe[1, 3] = 4
    jm = np.asarray(JH.layer_health_matrix(
        jnp.asarray(probe), {k: jnp.asarray(v) for k, v in g.items()}))
    tm = H.layer_health_matrix(torch.from_numpy(probe), t["g"]).numpy()
    np.testing.assert_allclose(tm, jm, rtol=1e-6)
    assert H.first_nonfinite_layer(tm) == JH.first_nonfinite_layer(jm)
    # every resolution order, on hand-made count columns
    for cols in ({1: [0, 2, 3]}, {3: [0, 1, 0]}, {3: [2, 2, 0]},
                 {5: [0, 0, 1]}, {}):
        m = np.zeros((3, 6), np.float32)
        for c, v in cols.items():
            m[:, c] = v
        assert H.first_nonfinite_layer(m) == JH.first_nonfinite_layer(m)
    # the flat-shard per-layer sums equal the whole leaf's
    gw = t["g"]["h.w"].reshape(-1)
    per = gw.numel() // 3
    pieces = [(gw[a:b], a, per) for a, b in ((0, 13), (13, 61), (61, 96))]
    whole = H.layer_grad_stats({"h.w": t["g"]["h.w"]})
    split = H.flat_layer_grad_stats(pieces, 3, "cpu")
    torch.testing.assert_close(split, whole, rtol=1e-6, atol=0,
                               equal_nan=True)


class _Clock:
    """A scripted `time.perf_counter`: every call advances it by the next
    step's share (start, mark, end: three calls a step)."""

    def __init__(self, steps):
        self.now = 1000.0
        self.deltas = []
        for s in steps:
            self.deltas += [0.0, s * 0.25, s * 0.75]
        self.i = 0

    def __call__(self):
        if self.i < len(self.deltas):
            self.now += self.deltas[self.i]
            self.i += 1
        return self.now


def _strip_ts(x):
    if isinstance(x, dict):
        return {k: _strip_ts(v) for k, v in x.items() if k != "ts"}
    if isinstance(x, list):
        return [_strip_ts(v) for v in x]
    return x


def _feed(telem, logger, steps, vecs, mats, to_dev, monkeypatch):
    monkeypatch.setattr(time, "perf_counter", _Clock(steps))
    reasons = []
    for i, (v, m) in enumerate(zip(vecs, mats)):
        with telem.step(index=i) as t:
            t.mark("data")
            telem.on_step_output(to_dev(v), layers=to_dev(m))
        h = telem.last_health
        logger.log(i, loss=h["loss"], step_s=telem.timer.times[-1],
                   **telem.step_record())
        reasons.append(telem.maybe_flush_flight(logger))
    telem.sample_stragglers(step_s=0.5, quantity="host_prep_s")
    logger.log_meta(kind="straggler", **telem.sample_stragglers(
        step_s=0.5, quantity="host_prep_s"))
    telem.flush(logger)
    monkeypatch.undo()
    return reasons


def test_registry_matches_jax(tmp_path, monkeypatch):
    """14 steps: 11 at 0.1 s, a 0.5 s step (the slow-step anomaly, the
    trace of the next step), a non-finite step (the edge-triggered
    flight flush) and a second non-finite one (no second flush)."""
    rng = np.random.default_rng(3)
    steps = [0.1] * 11 + [0.5, 0.1, 0.1]
    vecs, mats = [], []
    for i in range(len(steps)):
        v = np.array([5.0 - 0.1 * i, 1.5, 0.02, 30.0, 0.0], np.float32)
        m = np.abs(rng.standard_normal((2, 6))).astype(np.float32)
        m[:, [1, 3, 5]] = 0
        if i >= 12:
            v[0], v[4] = np.nan, 3.0
            m[1, 1] = 5.0
        vecs.append(v)
        mats.append(m)
    traces = {"jax": [], "port": []}
    out = {}
    for side, telem_cls, log_cls, to_dev in (
            ("jax", JTelemetry, JLogger, jnp.asarray),
            ("port", Telemetry, MetricsLogger, torch.from_numpy)):
        tr = traces[side]
        telem = telem_cls(trace_dir=str(tmp_path / side), layers=True,
                          flight_steps=8, anomaly_min_steps=10,
                          tracer=(tr.append, lambda: tr.append("stop")))
        path = tmp_path / f"{side}.jsonl"
        with log_cls(str(path), stdout=False) as logger:
            reasons = _feed(telem, logger, steps, vecs, mats, to_dev,
                            monkeypatch)
        recs = [json.loads(line) for line in open(path)]
        out[side] = (telem, reasons, recs)
    (jt, jr, jrecs), (pt, pr, precs) = out["jax"], out["port"]
    assert pr == jr == [None] * 11 + ["slow_step", "nonfinite", None]
    assert len(traces["port"]) == len(traces["jax"]) == 2
    assert traces["port"][1] == traces["jax"][1] == "stop"
    assert pt.snapshot() == jt.snapshot()
    assert pt.counters.keys() == jt.counters.keys()
    assert pt.counters["flight_flushes"].value == 2
    got, want = _strip_ts(precs), _strip_ts(jrecs)
    for g, w in zip(got, want):
        if "anomaly_trace" in w:  # the trace directory names the side
            assert g.pop("anomaly_trace").endswith("port/anomaly")
            assert w.pop("anomaly_trace").endswith("jax/anomaly")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert [r.get("kind") for r in precs].count("flight") == 2
    for rec in precs:
        assert PS.validate_record(rec) == [] == JS.validate_record(rec), rec


# -- the engines -------------------------------------------------------------

def _opts(name):
    """(JAX's optimizer, the port's) of the engine tests."""
    if name == "sgd":
        return (J.SGD(lr=1e-2, momentum=0.9, weight_decay=0.1),
                T.SGD(lr=1e-2, momentum=0.9, weight_decay=0.1))
    return (J.AdamW(lr=1e-3, weight_decay=0.1),
            T.AdamW(lr=1e-3, weight_decay=0.1))


def _jax_engine(cfg, telem=None, opt="adamw", **kw):
    jeng = J.SingleDevice(JGPT2(cfg), _opts(opt)[0],
                          mesh=J.make_mesh(devices=[jax.devices()[0]]),
                          telemetry=telem, **kw)
    return jeng, jeng.init(jax.random.PRNGKey(0))


def _port_engine(cfg, init, telem=None, opt="adamw", **kw):
    pm = T.build_model(cfg, device="cpu")
    eng = T.SingleDevice(pm, _opts(opt)[1],
                         device="cpu", telemetry=telem, **kw)
    state = eng.init(0)
    eng.load_params(state, T.params_from_numpy(init, "cpu"))
    return eng, state


def _batches(n, accum=1, b=2, t=32):
    loader = T.TokenLoader(None, b * accum, t, vocab_size=512, seed=3)
    out = []
    for _ in range(n):
        x, y = loader.next()
        if accum > 1:
            x, y = x.reshape(accum, b, t), y.reshape(accum, b, t)
        out.append((x, y))
    return out


def _fake():
    return (lambda path: None, lambda: None)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("layers,accum,opt", [
    (False, 1, "sgd"), (False, 1, "adamw"), (True, 2, "sgd")],
    ids=["on", "on-adamw", "layers-accum2"])
def test_single_device_telemetry_matches_jax(layers, accum, opt):
    """5 steps: health (and the layer matrix) every step within 1e-5 of
    JAX's (AdamW's update norm 1e-4, the module docstring); losses bit
    for bit the port's run without telemetry."""
    jt = JTelemetry(layers=layers, tracer=_fake())
    jeng, jstate = _jax_engine(JP["tiny"], jt, opt, accum_steps=accum)
    init = {n: np.asarray(p) for n, p in jstate.params.items()}
    pt = Telemetry(layers=layers, tracer=_fake())
    eng, state = _port_engine(T.GPT2_PRESETS["tiny"], init, pt, opt,
                              accum_steps=accum)
    bare, bstate = _port_engine(T.GPT2_PRESETS["tiny"], init, None, opt,
                                accum_steps=accum)
    want = ", telemetry=layers" if layers else ", telemetry=on"
    assert eng.describe().endswith(want + ")")
    assert eng._schedule.lowering == jeng._schedule.lowering == \
        ("probe" if layers else "plain")
    for i, (x, y) in enumerate(_batches(5, accum)):
        jstate, _ = jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, loss = eng.step(state, (x, y))
        bstate, bloss = bare.step(bstate, (x, y))
        assert float(loss) == float(bloss), i
        jh, th = jt.poll(), pt.poll()
        assert th["loss"] == float(loss)
        for k in jh:
            if k == "update_norm" and opt == "adamw":
                np.testing.assert_allclose(th[k], jh[k], rtol=1e-4)
                continue
            _close(th[k], jh[k], f"step {i} {k}")
        if layers:
            _close(pt.layer_health(), jt.layer_health(), f"step {i}")
    for n, p in state.params.items():
        assert torch.equal(p, bstate.params[n]), n


def test_layers_localize_a_nonfinite_weight():
    """An inf in layer 1's MLP weight: the forward poisons layer 1's
    output first; both packages name (1, "act_nonfinite")."""
    cfg = dataclasses.replace(JP["tiny"], n_layer=3)
    jt = JTelemetry(layers=True, tracer=_fake())
    jeng, jstate = _jax_engine(cfg, jt)
    init = {n: np.asarray(p).copy() for n, p in jstate.params.items()}
    init["h.mlp.fc.w"][1, 0, 0] = np.inf
    jstate = jstate.replace(params={n: jnp.asarray(v)
                                    for n, v in init.items()})
    pt = Telemetry(layers=True, tracer=_fake())
    eng, state = _port_engine(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                                  n_layer=3), init, pt)
    x, y = _batches(1)[0]
    jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
    eng.step(state, (x, y))
    want = H.first_nonfinite_layer(jt.layer_health())
    assert want == JH.first_nonfinite_layer(jt.layer_health()) == \
        (1, "act_nonfinite")
    assert H.first_nonfinite_layer(pt.layer_health()) == want
    np.testing.assert_array_equal(np.isfinite(pt.layer_health()),
                                  np.isfinite(jt.layer_health()))
    assert pt.poll()["nonfinite_grads"] > 0


def test_layers_refusals_match_jax():
    """MoE's blocks take no probe: JAX's message, from both
    build_schedule's.  The probe does not compose with the pipeline
    forward; the port has none yet, and its engines refuse pipeline
    parallelism before a schedule is built."""
    from tiny_deepspeed_tpu.models import build_model as jbuild
    from tiny_deepspeed_tpu.parallel import schedule as JSch
    jm = jbuild(J.models.ALL_PRESETS["moe-tiny"])
    pm = T.build_model(T.ALL_PRESETS["moe-tiny"], device="cpu")
    with pytest.raises(ValueError) as want:
        JSch.build_schedule(model=jm, stage=0, n_shard=1, busy_axes=(),
                            accum_steps=1, scan_unroll=1,
                            telemetry_layers=True)
    with pytest.raises(ValueError) as got:
        S.build_schedule(model=pm, stage=0, n_shard=1, telemetry_layers=True)
    assert str(got.value) == str(want.value)
    assert type(got.value) is type(want.value)
    with pytest.raises(ValueError, match="layer_health_capable=False"):
        T.SingleDevice(pm, T.AdamW(), device="cpu",
                       telemetry=Telemetry(layers=True))
    with pytest.raises(ValueError, match="pipeline_parallel"):
        T.SingleDevice(T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu"),
                       T.AdamW(), device="cpu",
                       telemetry=Telemetry(layers=True), pipeline_parallel=2)
    # the probe with a grad slot at data 2 composes, as in JAX
    gm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    for kw, low in ((dict(grad_buckets=2), "composed"), (dict(), "probe")):
        got = S.build_schedule(model=gm, stage=2, n_shard=2,
                               telemetry_layers=True, **kw)
        want = JSch.build_schedule(model=JGPT2(JP["tiny"]), stage=2,
                                   n_shard=2, busy_axes=(), accum_steps=1,
                                   scan_unroll=1, telemetry_layers=True,
                                   **kw)
        assert got.lowering == want.lowering == low
        assert got.describe() == want.describe()
    assert S.parse_sched_spec("health,grad_buckets=2") == \
        JSch.parse_sched_spec("health,grad_buckets=2")
