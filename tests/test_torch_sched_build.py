# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's `build_schedule` against JAX's, without training: the
lowering each knob set picks, and each refusal — its exception type and
its message, which names the conflicting slot (JAX tests/test_schedule.py
`TestLoweringTable`, `TestRefusals`) — at data 8 over the models of both
packages; the inert fallbacks on a 1-rank data axis; `parse_sched_spec`
on JAX's vocabulary (`health` and `pipe` refused naming ROADMAP.md); the
engines surfacing the schedule (`describe`, the codecs' refusals as
JAX's); `evenness_priority` shaping
`rank_map` as JAX's; and the training entry point at world 1 (inert, with
the warning) and refusing an unported `--sched` key by name.

JAX runs here on the CPU (tests/conftest.py), building models only.
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.parallel import schedule as S
from tiny_deepspeed_tpu_torch.parallel.mesh import ParallelContext
from test_torch_dist import world1  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GRAN2 = {i: i // 4 for i in range(8)}  # two granules of four ranks


def _models(preset, **over):
    """(the JAX model, the port's) of one preset."""
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    j = jbuild(dataclasses.replace(JP[preset], **over))
    t = T.build_model(dataclasses.replace(T.ALL_PRESETS[preset], **over),
                      device="cpu")
    return j, t


def _both(preset, over=None, n_shard=8, accum_steps=1, seq=False, **kw):
    """Build the schedule of `kw` with both packages: ((lowering or the
    exception), (lowering or the exception)) for JAX and the port."""
    from tiny_deepspeed_tpu.parallel import schedule as JS
    jm, tm = _models(preset, **(over or {}))
    out = []
    for build, model, busy in (
            (JS.build_schedule, jm, ("seq" if seq else None, None, None,
                                     None)),
            (S.build_schedule, tm, ["seq"] if seq else [])):
        args = dict(model=model, n_shard=n_shard, busy_axes=busy,
                    accum_steps=accum_steps, **kw)
        if build is JS.build_schedule:
            args["scan_unroll"] = 1
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                sched = build(**args)
            out.append((sched.lowering, sched.describe(),
                        [str(x.message) for x in w], sched.residual_len,
                        sched.auto_plan))
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("preset,over,kw,want", [
    ("tiny", None, dict(stage=0), "plain"),
    ("tiny", None, dict(stage=0, grad_buckets=2), "bucket"),
    ("tiny", None, dict(stage=1, grad_buckets=2), "bucket"),
    ("tiny", None, dict(stage=2, grad_buckets=2), "bucket"),
    ("tiny", None, dict(stage=3, gather_prefetch=2), "prefetch"),
    ("tiny", None, dict(stage=3, gather_prefetch=2, gather_groups=2),
     "prefetch"),
    ("tiny", None, dict(stage=3, grad_buckets=2), "composed"),
    ("tiny", None, dict(stage=3, gather_prefetch=2, grad_buckets=2),
     "composed"),
    ("tiny", None, dict(stage=3, hpz=True, granule_of=GRAN2), "composed"),
    ("tiny", None, dict(stage=3, hpz=True, granule_of=GRAN2,
                        gather_prefetch=2, grad_buckets=2), "composed"),
    ("tiny", dict(gather_quant="fp8"), dict(stage=0, grad_buckets=2),
     "composed"),
    ("tiny", dict(gather_quant="fp8"), dict(stage=3, gather_prefetch=2),
     "prefetch"),
    ("llama-tiny", None, dict(stage=3, gather_prefetch=2), "prefetch"),
    ("llama-tiny", None, dict(stage=2, grad_buckets=2), "bucket"),
    ("tiny", None, dict(stage=0, grad_comm="int8"), "quant_mono"),
    ("tiny", None, dict(stage=1, grad_comm="fp8", grad_comm_block=128),
     "quant_mono"),
    ("tiny", None, dict(stage=2, grad_comm="int8", grad_comm_groups=2),
     "quant_mono"),
    ("tiny", None, dict(stage=0, grad_comm="int8",
                        grad_comm_error_feedback=False), "quant_mono"),
    ("tiny", None, dict(stage=0, grad_comm="int8", grad_buckets=2),
     "bucket"),
    ("tiny", None, dict(stage=3, grad_comm="int8"), "composed"),
    ("tiny", None, dict(stage=3, grad_comm="fp8", grad_comm_tail="int8",
                        gather_prefetch=2, grad_buckets=2), "composed"),
    ("tiny", None, dict(stage=3, hpz=True, hpz_comm="int8",
                        granule_of=GRAN2), "composed"),
    ("tiny", None, dict(stage=3, hpz=True, hpz_comm="fp8", granule_of=GRAN2,
                        grad_comm="int8", grad_comm_tail="fp8"), "composed"),
    ("tiny", dict(gather_quant="fp8"), dict(stage=0, grad_comm="int8"),
     "quant_mono"),
    ("moe-tiny", None, dict(stage=0, grad_comm="int8"), "quant_mono"),
    ("tiny", None, dict(stage=0, grad_comm="auto", grad_buckets="auto",
                        granule_of=GRAN2), "bucket"),
    ("tiny", None, dict(stage=0, grad_comm="auto", granule_of=None),
     "quant_mono"),
    ("tiny", None, dict(stage=3, gather_prefetch=2, gather_groups="auto",
                        granule_of=GRAN2), "prefetch"),
    ("tiny", None, dict(stage=3, gather_prefetch=2, gather_groups="auto",
                        grad_comm="auto", granule_of=GRAN2), "composed"),
    ("tiny", None, dict(stage=0, grad_buckets="auto", granule_of=GRAN2),
     "plain"),
], ids=["plain", "ddp-buckets", "zero1-buckets", "zero2-buckets",
        "zero3-prefetch", "zero3-2hop", "zero3-buckets-implicit-gather",
        "zero3-prefetch-buckets", "zero3-hpz", "zero3-hpz-prefetch-buckets",
        "fp8-buckets-composed", "fp8-zero3-prefetch", "llama-prefetch",
        "llama-zero2-buckets", "ddp-int8", "zero1-fp8-block128",
        "zero2-int8-2hop", "ddp-int8-no-ef", "ddp-int8-buckets",
        "zero3-int8-implicit-gather", "zero3-fp8-tail-int8-prefetch-buckets",
        "zero3-hpz-int8", "zero3-hpz-fp8-int8-tail-fp8", "fp8-gather-ddp-int8",
        "moe-ddp-int8", "auto-grad-comm-buckets", "auto-one-granule",
        "auto-gather-groups", "auto-gather-groups-composed",
        "auto-buckets-fp32"])
def test_lowering_equals_jax(preset, over, kw, want):
    j, t = _both(preset, over, **kw)
    assert j[0] == t[0] == want
    assert j[1] == t[1]  # describe(): the same slots and lowering
    assert j[3] == t[3]  # the residual row's length
    assert j[4] == t[4]  # the resolved "auto" plan
    if kw.get("hpz"):
        from tiny_deepspeed_tpu.parallel import schedule as JS
        assert S.hpz_groups(GRAN2, 8) == JS.hpz_groups(GRAN2, 8) == (
            [[0, 1, 2, 3], [4, 5, 6, 7]],
            [[0, 4], [1, 5], [2, 6], [3, 7]], 4, 2)


@pytest.mark.parametrize("kw", [
    dict(stage=0, grad_buckets=2), dict(stage=3, gather_prefetch=2),
    dict(stage=3, grad_buckets=2, hpz=True),
    dict(stage=0, gather_prefetch=2, hpz=True),
    dict(stage=0, grad_comm="int8"),
    dict(stage=3, grad_comm="fp8", grad_comm_tail="int8"),
    dict(stage=2, grad_comm="int8", grad_buckets=2,
         grad_comm_error_feedback=False),
], ids=["buckets", "prefetch", "buckets-hpz", "stage0-gather", "int8",
        "zero3-fp8-tail", "zero2-int8-buckets-no-ef"])
def test_inert_on_one_rank_as_jax(kw):
    """A 1-rank data axis: every slot warns and the plain path runs —
    before the stage check (a gather slot at stage 0 is inert, not
    refused)."""
    j, t = _both("tiny", n_shard=1, **kw)
    assert j[0] == t[0] == "plain"
    assert j[2] == t[2] and all("inert" in m for m in t[2]) and t[2]


@pytest.mark.parametrize("preset,kw", [
    ("tiny", dict(stage=3, grad_buckets=2, accum_steps=2)),
    ("tiny", dict(stage=3, gather_prefetch=2, gather_groups=2,
                  grad_buckets=2)),
    ("tiny", dict(stage=3, hpz=True, gather_prefetch=2, gather_groups=2)),
    ("tiny", dict(stage=3, gather_prefetch=2, grad_buckets=3)),
    ("tiny", dict(stage=2, gather_prefetch=2)),
    ("tiny", dict(stage=2, hpz=True, granule_of=GRAN2)),
    ("tiny", dict(stage=3, gather_prefetch=3)),
    ("tiny", dict(stage=3, gather_prefetch=2, gather_groups=3)),
    ("tiny", dict(stage=3, gather_prefetch=2, gather_groups=8)),
    ("tiny", dict(stage=0, grad_buckets=2, seq=True)),
    ("tiny", dict(stage=3, gather_prefetch=2, seq=True)),
    ("tiny", dict(stage=3, hpz=True, granule_of=None)),
    ("tiny", dict(stage=3, hpz=True, granule_of={i: 0 for i in range(8)})),
    ("tiny", dict(stage=3, hpz=True, granule_of={i: i % 2
                                                 for i in range(8)})),
    ("tiny", dict(stage=3, hpz=True, granule_of={i: i // 4
                                                 for i in range(6)})),
    ("moe-tiny", dict(stage=3, grad_buckets=2)),
    ("moe-tiny", dict(stage=0, grad_buckets=2)),
    ("moe-tiny", dict(stage=3, gather_prefetch=2)),
    ("tiny", dict(stage=2, grad_comm="int8", grad_comm_tail="int8")),
    ("tiny", dict(stage=3, grad_comm_tail="int8")),
    ("tiny", dict(stage=3, hpz_comm="fp8")),
    ("tiny", dict(stage=3, grad_comm="int8", grad_comm_tail="int4")),
    ("tiny", dict(stage=3, hpz=True, hpz_comm="bf16", granule_of=GRAN2)),
    ("tiny", dict(stage=0, grad_comm="int4")),
    ("tiny", dict(stage=0, grad_comm="int8", grad_comm_groups=3)),
    ("tiny", dict(stage=0, grad_comm="int8", grad_comm_groups=8)),
    ("tiny", dict(stage=0, grad_comm="int8", grad_comm_groups=1)),
    ("tiny", dict(stage=0, grad_comm="int8", seq=True)),
    ("tiny", dict(stage=3, grad_comm="int8", accum_steps=2)),
    ("tiny", dict(stage=0, grad_comm="int8", grad_buckets=3)),
    ("moe-tiny", dict(stage=3, grad_comm="int8")),
    ("moe-tiny", dict(stage=0, grad_comm="int8", grad_buckets=2)),
    ("tiny", dict(stage=3, hpz=True, hpz_comm="int8", granule_of=None)),
], ids=["composed-accum", "composed-2hop", "hpz-2hop", "buckets-divide",
        "prefetch-needs-zero3", "hpz-needs-zero3", "prefetch-past-layers",
        "groups-divide", "groups-proper", "grad-seq", "gather-seq",
        "hpz-no-map", "hpz-one-granule", "hpz-not-contiguous",
        "hpz-map-short", "moe-composed", "moe-bucket", "moe-prefetch",
        "tail-needs-zero3", "tail-needs-codec", "hpz-comm-needs-hpz",
        "tail-mode", "hpz-mode", "grad-mode", "grad-groups-divide",
        "grad-groups-proper", "grad-groups-one", "codec-seq",
        "codec-composed-accum", "codec-buckets-divide", "moe-codec-composed",
        "moe-codec-bucket", "hpz-comm-no-map"])
def test_refusal_equals_jax(preset, kw):
    """Each refusal: JAX's exception type and message (the slot named)."""
    over = {"n_layer": 2} if preset == "tiny" else None
    j, t = _both(preset, over, **kw)
    assert j[0] in ("ScheduleConflictError", "ValueError"), j
    assert t == j


def test_layout_and_granule_geometry_equal_jax():
    """`bucket_layout`'s fp32 geometry, `_hier_groups` and
    `granule_geometry` as JAX's; one host is one granule (no map)."""
    import tiny_deepspeed_tpu.parallel.comm as JC
    import tiny_deepspeed_tpu.parallel.mesh as JM
    from tiny_deepspeed_tpu_torch.parallel import comm as C
    from tiny_deepspeed_tpu_torch.parallel import mesh as M
    jm, tm = _models("tiny", n_layer=4)
    want = JC.bucket_layout(jm.param_shapes(), 4, 2, 8)
    got = C.bucket_layout(tm.param_shapes(), 4, 2)
    assert got == {k: want[k] for k in got}
    assert C._hier_groups(8, 2) == JC._hier_groups(8, 2)
    for gmap, n in ((None, 8), ({}, 4), (GRAN2, 8), ({0: 0, 1: 0, 2: 1}, 3),
                    ({i: 0 for i in range(4)}, 4)):
        assert M.granule_geometry(gmap, n) == JM.granule_geometry(gmap, n)


def test_granule_map_of_one_host(world1):
    pctx = T.parallel.make_context()
    assert T.parallel.mesh.granule_map(pctx) is None


def test_parse_sched_spec_ported_vocabulary():
    """JAX's vocabulary, the codecs and "auto" included, parses as JAX's
    does; only the telemetry probe slot and the pipe slot are refused,
    naming ROADMAP.md."""
    from tiny_deepspeed_tpu.parallel.schedule import parse_sched_spec as jp
    spec = "gather_prefetch=2,grad_buckets=4,gather_groups=2,hpz"
    assert S.parse_sched_spec(spec) == jp(spec) == {
        "gather_prefetch": 2, "grad_buckets": 4, "gather_groups": 2,
        "hpz": True}
    assert S.parse_sched_spec("grad_comm=fp32,hpz_comm=fp32") == {
        "grad_comm": "fp32", "hpz_comm": "fp32"}
    for good in ("grad_comm=int8", "grad_comm_groups=2",
                 "grad_comm_tail=int8", "hpz_comm=fp8", "grad_buckets=auto",
                 "gather_groups=auto", "grad_comm=auto",
                 "grad_comm_block=128", "grad_comm=fp8,grad_buckets=2,hpz"):
        assert S.parse_sched_spec(good) == jp(good), good
    for bad in ("health", "pipe=interleaved:2"):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            S.parse_sched_spec(bad)
    for bad in ("grad_comm=int4", "hpz_comm=bf16", "grad_comm_tail=auto"):
        with pytest.raises(ValueError) as got:
            S.parse_sched_spec(bad)
        with pytest.raises(ValueError) as want:
            jp(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown --sched key 'warp'"):
        S.parse_sched_spec("warp=9")
    with pytest.raises(ValueError, match="not 'key=value'"):
        S.parse_sched_spec("gather_prefetch")


def _fake_pctx(n=2):
    """A data-n context no collective is ever run on (construction only)."""
    return ParallelContext(world=n, rank=0, data_size=n, seq_size=1,
                           data_rank=0, seq_rank=0)


@pytest.mark.parametrize("name,kw,want", [
    ("DDP", dict(grad_buckets=2), "grad_buckets=2,grad_comm=fp32@bucket"),
    ("Zero2", dict(grad_buckets=2), "grad_buckets=2,grad_comm=fp32@bucket"),
])
def test_engine_describe_names_the_lowering(name, kw, want):
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    eng = getattr(T, name)(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                           **kw)
    assert eng._schedule.lowering == "bucket"
    assert f"sched={want}" in eng.describe()


@pytest.mark.parametrize("kw", [
    dict(grad_comm="int8"), dict(grad_comm_groups=2),
    dict(grad_comm_tail="int8"), dict(hpz=True, hpz_comm="fp8"),
    dict(grad_buckets="auto"), dict(gather_prefetch=2,
                                    gather_groups="auto"),
    dict(telemetry=object())])
def test_engine_refuses_the_codecs_naming_roadmap(kw):
    """Of these knobs only telemetry is still refused naming ROADMAP.md;
    the codecs and "auto" build on Zero3 at data 2, or raise JAX's
    message where JAX refuses them (a granule map of one host stands in
    for the hosts' collective)."""
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    if "telemetry" in kw:
        with pytest.raises(ValueError, match="ROADMAP.md"):
            T.Zero3(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(), **kw)
        return
    gmap = {0: 0, 1: 1} if kw.get("hpz") else {0: 0, 1: 0}
    want = {"grad_comm": "grad_buckets=1,grad_comm=int8@composed",
            "grad_comm_groups": "grad_comm_groups requires grad_comm=",
            "grad_comm_tail": "grad_comm_tail composes with a quantized",
            "hpz_comm": "gather_prefetch=1+hpz[fp8]@composed",
            "grad_buckets": "plain", "gather_groups": "gather_prefetch=2@"
            "prefetch"}[next(k for k in ("grad_comm_groups",
                                          "grad_comm_tail", "grad_comm",
                                          "hpz_comm", "grad_buckets",
                                          "gather_groups") if k in kw)]
    if kw.get("hpz"):  # hpZ's executor makes process groups: the schedule
        sched = S.build_schedule(model=pm, stage=3, n_shard=2,
                                 granule_of=gmap, **kw)
        assert sched.describe().endswith(want)
        return
    try:
        eng = T.Zero3(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                      hpz_granule_of=gmap, **kw)
    except ValueError as e:
        assert want in str(e) and "ROADMAP.md" not in str(e)
        return
    assert eng._schedule.describe().endswith(want)


@pytest.mark.parametrize("kw", [
    dict(grad_comm="int4"), dict(grad_comm_groups=2),
    dict(grad_comm="int8", grad_comm_tail="bf16"),
    dict(hpz=True, hpz_comm="int4"), dict(grad_buckets=-1),
], ids=["grad-comm", "groups-without-codec", "tail-mode", "hpz-mode",
        "buckets"])
def test_engine_codec_knob_refusals_equal_jax(kw):
    """The engine's own checks of the codec knobs (JAX engine.py:582-624),
    before any schedule: the message JAX's engine gives."""
    import jax
    import tiny_deepspeed_tpu as J
    jm, tm = _models("tiny")
    mesh = J.make_mesh((2,), ("data",), devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        J.DDP(jm, J.AdamW(lr=1e-3), mesh=mesh, **kw)
    with pytest.raises(ValueError) as got:
        T.DDP(tm, T.AdamW(), device="cpu", pctx=_fake_pctx(), **kw)
    assert str(got.value) == str(want.value)


def test_engine_surfaces_the_conflict():
    """The engine raises the scheduler's error, as JAX's does."""
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    with pytest.raises(S.ScheduleConflictError, match="accum_steps"):
        T.Zero3(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                grad_buckets=2, accum_steps=2)
    with pytest.raises(ValueError, match="gather_groups requires"):
        T.Zero3(pm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                gather_groups=2)


def test_evenness_priority_rank_map_equals_jax():
    """`evenness_priority` reaches `partition_tensors`: the rank map at a
    nonzero priority equals JAX's engine's (and differs from the default),
    with JAX's warning."""
    import jax
    import tiny_deepspeed_tpu as J
    jm, tm = _models("tiny")
    mesh = J.make_mesh((2,), ("data",), devices=jax.devices()[:2])
    with pytest.warns(UserWarning, match="evenness_priority"):
        jeng = J.DDP(jm, J.AdamW(lr=1e-3), mesh=mesh, evenness_priority=0.9)
    with pytest.warns(UserWarning, match="evenness_priority"):
        teng = T.DDP(tm, T.AdamW(), device="cpu", pctx=_fake_pctx(),
                     evenness_priority=0.9)
    base = T.DDP(tm, T.AdamW(), device="cpu", pctx=_fake_pctx())
    assert teng.rank_map == jeng.rank_map
    assert teng.rank_map != base.rank_map


@pytest.mark.parametrize("flags", [
    ["--engine", "zero3", "--gather-prefetch", "2"],
    ["--engine", "zero3", "--sched", "grad_buckets=2,gather_prefetch=2"],
], ids=["gather-prefetch", "sched"])
def test_train_module_runs_the_knobs_inert(flags):
    """At world 1 (no torchrun) the knobs build, warn that they are inert
    and train the plain path."""
    out = subprocess.run(
        [sys.executable, "-W", "always", "-m",
         "tiny_deepspeed_tpu_torch.train", "--device", "cpu", "--model",
         "tiny", "--iters", "2", "--seq-len", "32", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "gather slot (gather_prefetch=2) is inert" in out.stderr
    assert ("grad slot" in out.stderr) == ("grad_buckets" in flags[-1])
    assert out.stdout.splitlines()[-1].startswith("done: 2 iters in ")


def test_train_refuses_an_unported_sched_key():
    from tiny_deepspeed_tpu_torch import train
    with pytest.raises(ValueError, match="health.*ROADMAP.md"):
        train.main(["--device", "cpu", "--model", "tiny", "--iters", "1",
                    "--sched", "gather_prefetch=2,grad_comm=int8,health"])
