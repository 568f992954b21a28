# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The in-step collective schedule (parallel/schedule.py) against JAX's
engines, on the CPU over gloo: the bucketed gradient release and the
ZeRO-3 gather prefetch.

Each case runs through `check_against_jax` (tests/test_torch_dist.py):
the JAX package's tiny preset in f32 at 4 layers (room for 2 buckets
and a 3-deep prefetch), its init crossing through numpy, 10 AdamW steps
on both sides with the same knobs — the loss trajectory within 1e-4
relative, the gathered params and optimizer state within 1e-5 (fp8:
2e-4) on the held elements, the rank map equal to JAX's.  The lowering
each side picked is pinned too (`Schedule.lowering`).  Cases:

- DDP `grad_buckets=2` at data 2 (JAX's "bucket" lowering: the
  releases from inside the backward, the tail after it);
- Zero2 `grad_buckets=2, accum_steps=2` at data 2 (the same, the first
  microbatch summed locally and folded into the last one's releases,
  each bucket reduce-scattered into the flat shard);
- Zero3 `gather_prefetch=2` at data 2, and `gather_prefetch=3` under the
  fp8 gather ("prefetch": the on-demand numbers, gathered ahead);
- Zero3 `gather_prefetch=2` on `llama-tiny` (2 layers) at data 2;
- the telemetry (SGD, so every health field is held at 1e-5:
  tests/test_torch_telemetry.py), each step's health and, in layers
  mode, (n_layer, 6) matrix within 1e-5 relative of JAX's: Zero2 in
  layers mode (the "probe" lowering: the probe's sums over each rank's
  tokens all-reduced with the shards' partial sums), Zero2
  `grad_buckets=2` in layers mode ("composed": the executor's recompute
  taps each layer; the dact column divided by n^2), DDP in layers mode
  (stage 0: whole replicated leaves summed locally, the probe
  all-reduced on its own), Zero1 with the telemetry on (the rank's
  slices of the reduced whole gradients) and Zero3 in layers mode (the
  (n_layer, ...) shards' per-layer sums, the probe through the
  on-demand gather).

tests/test_torch_sched_zero3.py holds the 2-hop gather, hpZ and the
composed lowering; tests/test_torch_sched_build.py the lowering table
and the refusals.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import pytest

from test_torch_dist import check_case, check_health, run_cases

L4 = {"n_layer": 4}
DATA2 = {
    "ddp-buckets2": ("DDP", dict(grad_buckets=2), 1, L4, 1e-5, "bucket"),
    "zero2-buckets2-accum2": ("Zero2", dict(grad_buckets=2), 2, L4, 1e-5,
                              "bucket"),
    "zero3-prefetch2": ("Zero3", dict(gather_prefetch=2), 1, L4, 1e-5,
                        "prefetch"),
    "zero3-prefetch3-fp8": ("Zero3", dict(gather_prefetch=3), 1,
                            dict(L4, gather_quant="fp8"), 2e-4, "prefetch"),
}


# the telemetry: (engine, knobs, mode, lowering)
LAYERS = {"zero2-layers": ("Zero2", dict(), "layers", "probe"),
          "zero2-buckets2-layers": ("Zero2", dict(grad_buckets=2), "layers",
                                    "composed"),
          "ddp-layers": ("DDP", dict(), "layers", "probe"),
          "zero1-on": ("Zero1", dict(), "on", "plain"),
          "zero3-layers": ("Zero3", dict(), "layers", "probe")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of this file in one 2-rank gloo spawn."""
    cases = {cid: dict(name=name, dp=2, sp=1, kw=kw, accum=accum,
                       model_kw=model_kw)
             for cid, (name, kw, accum, model_kw, _, _) in DATA2.items()}
    cases["llama"] = dict(name="Zero3", dp=2, sp=1,
                          kw=dict(gather_prefetch=2), preset="llama-tiny")
    for cid, (name, kw, mode, _) in LAYERS.items():
        cases[cid] = dict(name=name, dp=2, sp=1, kw=kw, opt="sgd",
                          model_kw=L4, telemetry=mode)
    return run_cases(tmp_path_factory.mktemp("sched"), cases)


@pytest.mark.parametrize("case", list(DATA2))
def test_schedule_matches_jax_data2(runs, case):
    _, _, accum, _, atol, lowering = DATA2[case]
    # the accumulated step's 8 random rows sit at ln(512) from the start:
    # JAX's loss does not fall over 10 steps either
    res, _, jeng, *_ = check_case(runs, case, atol=atol,
                                  progress=accum == 1)
    assert jeng._schedule.lowering == res["lowering"] == lowering


def test_llama_zero3_prefetch_matches_jax(runs):
    """llama-tiny's loss does not fall over 10 steps on JAX either."""
    res, _, jeng, *_ = check_case(runs, "llama", progress=False)
    assert jeng._schedule.lowering == res["lowering"] == "prefetch"


@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_health_matches_jax_data2(runs, case):
    res, _, jeng, *_ = check_case(runs, case, atol=1e-5)
    _, _, mode, lowering = LAYERS[case]
    assert jeng._schedule.lowering == res["lowering"] == lowering
    check_health(res, jeng, mode, n_layer=4)
