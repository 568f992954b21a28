# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's DDP and ZeRO-1 with SGD (momentum, weight decay) at world 2
(data 2) against the JAX engines, as tests/test_torch_dist.py compares
them: 10-step losses within 1e-4 relative, and params and velocity on
every element within 1e-5 (SGD's step is linear in the gradient, so
roundoff stays roundoff)."""

import pytest

from test_torch_dist import check_case, run_cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines in one 2-rank gloo spawn."""
    return run_cases(tmp_path_factory.mktemp("sgd"), {
        n: dict(name=n, dp=2, sp=1, opt="sgd") for n in ("DDP", "Zero1")})


@pytest.mark.parametrize("name", ["DDP", "Zero1"])
def test_sgd_matches_jax(runs, name):
    check_case(runs, name)
