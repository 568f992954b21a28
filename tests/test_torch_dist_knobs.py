# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's ZeRO engines at world 2 (data 2) with the step's knobs,
against the JAX engines as tests/test_torch_dist.py compares them: SGD
with momentum under ZeRO-2 (params and velocity to 1e-5 on every
element; tests/test_torch_dist_sgd.py holds DDP and ZeRO-1 so),
`accum_steps=2` under ZeRO-2 (every microbatch reduce-scattered
into the f32 shard) and a dynamic-scale overflow skip under ZeRO-1."""

from test_torch_dist import check_against_jax


def test_zero2_sgd_matches_jax(tmp_path):
    check_against_jax(tmp_path, "Zero2", 2, 1, opt="sgd")


def test_zero2_accum2_matches_jax(tmp_path):
    check_against_jax(tmp_path, "Zero2", 2, 1, accum=2)


def test_zero1_dynamic_scale_overflow_skips_like_jax(tmp_path):
    check_against_jax(tmp_path, "Zero1", 2, 1,
                      dict(loss_scale="dynamic"), overflow=True)
