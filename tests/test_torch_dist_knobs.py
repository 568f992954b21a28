# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's ZeRO engines at world 2 (data 2) with the step's knobs,
against the JAX engines as tests/test_torch_dist.py compares them: SGD
with momentum under ZeRO-2 (params and velocity to 1e-5 on every
element; tests/test_torch_dist_sgd.py holds DDP and ZeRO-1 so),
`accum_steps=2` under ZeRO-2 (every microbatch reduce-scattered
into the f32 shard) and a dynamic-scale overflow skip under ZeRO-1."""

import pytest

from test_torch_dist import check_case, run_cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three cases in one 2-rank gloo spawn."""
    return run_cases(tmp_path_factory.mktemp("knobs"), {
        "sgd": dict(name="Zero2", dp=2, sp=1, opt="sgd"),
        "accum2": dict(name="Zero2", dp=2, sp=1, accum=2),
        "overflow": dict(name="Zero1", dp=2, sp=1,
                         kw=dict(loss_scale="dynamic"), overflow=True)})


def test_zero2_sgd_matches_jax(runs):
    check_case(runs, "sgd")


def test_zero2_accum2_matches_jax(runs):
    check_case(runs, "accum2")


def test_zero1_dynamic_scale_overflow_skips_like_jax(runs):
    check_case(runs, "overflow")
