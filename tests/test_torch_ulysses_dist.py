# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Ulysses under DDP and Zero2 at data 2 x seq 2 (one 4-rank gloo spawn)
against the JAX engines with seq_impl="ulysses", 10 steps, as
tests/test_torch_ulysses.py holds its seq-2 spawn (a file of its own so
that neither file's serial time passes a minute).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import pytest

from test_torch_ulysses import check_spawn


@pytest.mark.parametrize("spawn_id", ["data2_seq2"])
def test_engines_under_ulysses_match_jax(tmp_path, spawn_id):
    check_spawn(tmp_path, spawn_id)
