# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The grad-comm codecs through DDP, Zero1 and Zero2 against JAX's
engines, on the CPU over gloo: 10 AdamW steps of the tiny preset (f32)
on both sides with the same knobs and JAX's int8 dither patched into the
port (`check_codec_against_jax`, tests/test_torch_grad_comm.py): the
free-running losses within 1e-4 relative, and each step run again from
JAX's state before it — its loss within 1e-4 relative, params, AdamW
state and every rank's residual row within 1e-5 (fp8: 2e-4) on at least
99% of the held elements; the lowering equal to JAX's.  (Free-running,
the states drift apart: measured on the CPU, DDP int8 at data 2 held
71% of the elements within 1e-5 after 10 steps while its losses stayed
within 6e-6 relative — a code flipped by roundoff near zero moves
Adam's first step by up to lr.)  Cases:

- DDP int8 and fp8, Zero1 int8 at data 2 ("quant_mono": each rank's own
  batch as on one device, one error-fed sync);
- Zero2 int8 with `accum_steps=2` (the microbatches summed locally, one
  sync, each rank keeping its shard).

tests/test_torch_grad_comm_knobs.py holds the overflow, no error
feedback, the 2-hop groups, MoE and the buckets;
tests/test_torch_grad_comm_zero3.py ZeRO-3, the tail codec and hpZ's
rebuild codec.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import pytest

from test_torch_grad_comm import check_codec_case, run_codec_cases

INT8 = dict(grad_comm="int8")
CASES = {
    "ddp-int8": dict(name="DDP", dp=2, kw=INT8),
    "ddp-fp8": dict(name="DDP", dp=2, kw=dict(grad_comm="fp8"), atol=2e-4),
    "zero1-int8": dict(name="Zero1", dp=2, kw=INT8),
    "zero2-int8-accum2": dict(name="Zero2", dp=2, kw=INT8, accum=2),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four cases in one 2-rank gloo spawn."""
    return run_codec_cases(tmp_path_factory.mktemp("codec_engines"), CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_quant_mono_matches_jax(runs, case):
    res, _, _ = check_codec_case(runs, case)
    assert res["lowering"] == "quant_mono"
    assert res["forced"][-1]["residual"] is not None
