# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's DDP and ZeRO-1 with SGD (momentum, weight decay) at world 2
(data 2) against the JAX engines, as tests/test_torch_dist.py compares
them: 10-step losses within 1e-4 relative, and params and velocity on
every element within 1e-5 (SGD's step is linear in the gradient, so
roundoff stays roundoff)."""

import pytest

from test_torch_dist import check_against_jax


@pytest.mark.parametrize("name", ["DDP", "Zero1"])
def test_sgd_matches_jax(tmp_path, name):
    check_against_jax(tmp_path, name, 2, 1, opt="sgd")
