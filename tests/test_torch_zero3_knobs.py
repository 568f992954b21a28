# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's ZeRO-3 at data 2 with the step's knobs, against the JAX
`Zero3` as tests/test_torch_zero3.py compares them: `accum_steps=2`
(every microbatch reduce-scattered into the f32 shard accumulator),
global-norm clipping over the shards, SGD with momentum (params and
velocity to 1e-5 on every element) and a dynamic-scale overflow skip."""

import pytest

from test_torch_dist import check_case, run_cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four cases in one 2-rank gloo spawn."""
    z3 = dict(name="Zero3", dp=2, sp=1)
    return run_cases(tmp_path_factory.mktemp("zero3_knobs"), {
        "accum2": dict(z3, accum=2),
        "clip": dict(z3, kw=dict(grad_clip=0.05)),
        "sgd": dict(z3, opt="sgd"),
        "overflow": dict(z3, kw=dict(loss_scale="dynamic"), overflow=True)})


def test_zero3_accum2_matches_jax(runs):
    check_case(runs, "accum2")


def test_zero3_grad_clip_matches_jax(runs):
    check_case(runs, "clip")


def test_zero3_sgd_matches_jax(runs):
    check_case(runs, "sgd")


def test_zero3_dynamic_scale_overflow_skips_like_jax(runs):
    check_case(runs, "overflow")
