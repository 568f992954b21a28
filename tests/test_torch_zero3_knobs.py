# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's ZeRO-3 at data 2 with the step's knobs, against the JAX
`Zero3` as tests/test_torch_zero3.py compares them: `accum_steps=2`
(every microbatch reduce-scattered into the f32 shard accumulator),
global-norm clipping over the shards, SGD with momentum (params and
velocity to 1e-5 on every element) and a dynamic-scale overflow skip."""

from test_torch_dist import check_against_jax


def test_zero3_accum2_matches_jax(tmp_path):
    check_against_jax(tmp_path, "Zero3", 2, 1, accum=2)


def test_zero3_grad_clip_matches_jax(tmp_path):
    check_against_jax(tmp_path, "Zero3", 2, 1, dict(grad_clip=0.05))


def test_zero3_sgd_matches_jax(tmp_path):
    check_against_jax(tmp_path, "Zero3", 2, 1, opt="sgd")


def test_zero3_dynamic_scale_overflow_skips_like_jax(tmp_path):
    check_against_jax(tmp_path, "Zero3", 2, 1,
                      dict(loss_scale="dynamic"), overflow=True)
