# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The grad-comm codecs' knobs through the engines against JAX's, on the
CPU over gloo, held as tests/test_torch_grad_comm_engines.py holds its
cases (`check_codec_against_jax`: JAX's int8 dither patched in, 10 AdamW
steps of the tiny preset, the free-running losses and every step
teacher-forced from JAX's state):

- DDP int8 under a dynamic loss scale whose first step overflows: the
  step is skipped and the residual rolled back with the state, as JAX's
  (4 steps);
- DDP int8 without error feedback (no residual);
- DDP int8 with `grad_comm_groups=2` at data 4 (the 2-hop schedule);
- moe-tiny DDP int8 ("quant_mono": the experts routed within each
  rank's shard, as JAX's replay with pctx=None routes them);
- DDP int8 `grad_buckets=2` at 4 layers ("bucket": each bucket's
  reduce-scatter issued from inside the backward with its residual
  slice, the tail's after it, the row [b0 | b1 | tail]).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import numpy as np
import pytest

from test_torch_grad_comm import check_codec_case, run_codec_cases

INT8 = dict(grad_comm="int8")
KNOBS = {
    "ddp-int8-no-ef": (2, dict(INT8, grad_comm_error_feedback=False)),
    "ddp-int8-2hop-data4": (4, dict(INT8, grad_comm_groups=2)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of this file: one gloo spawn a data size (2 and 4)."""
    cases = {cid: dict(name="DDP", dp=dp, kw=kw)
             for cid, (dp, kw) in KNOBS.items()}
    cases.update({
        "overflow": dict(name="DDP", dp=2,
                         kw=dict(INT8, loss_scale="dynamic"), overflow=True),
        "moe": dict(name="DDP", dp=2, kw=INT8, preset="moe-tiny"),
        "buckets": dict(name="DDP", dp=2, kw=dict(INT8, grad_buckets=2),
                        model_kw={"n_layer": 4})})
    return run_codec_cases(tmp_path_factory.mktemp("codec_knobs"), cases)


@pytest.mark.parametrize("case", list(KNOBS))
def test_codec_knobs_match_jax(runs, case):
    kw = KNOBS[case][1]
    res, _, jeng = check_codec_case(runs, case)
    assert res["lowering"] == "quant_mono"
    ef = kw.get("grad_comm_error_feedback", True)
    assert (res["forced"][-1]["residual"] is not None) == ef
    assert jeng._schedule.grad.groups == kw.get("grad_comm_groups")


def test_quant_mono_overflow_rolls_the_residual_back(runs):
    """The first step overflows: skipped, the residual row kept as it was
    (zeros) on every rank; the next steps train and fill it."""
    res, _, _ = check_codec_case(runs, "overflow")
    forced = res["forced"]
    assert not np.isfinite(forced[0]["loss"])
    assert forced[0]["residual"].abs().max() == 0
    assert forced[-1]["residual"].abs().max() > 0


def test_moe_quant_mono_matches_jax(runs):
    res, _, _ = check_codec_case(runs, "moe")
    assert res["lowering"] == "quant_mono"


def test_buckets_match_jax(runs):
    res, js, jeng = check_codec_case(runs, "buckets")
    assert res["lowering"] == "bucket"
    lay = jeng._schedule.layout
    assert js["res"].shape[1] == 2 * lay["bucket_pad"] + lay["tail_pad"] \
        == jeng._schedule.residual_len
