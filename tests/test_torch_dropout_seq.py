# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Dropout 0.1 under Zero2 at data 2 x seq 2, with the ring and with
Ulysses (one 4-rank gloo spawn), held as tests/test_torch_dropout_dist.py
holds its data-2 spawn: each rank's masks bit for bit its block of the
one-rank mask, losses within 1e-5 of SingleDevice's, and with JAX's
masks patched in, JAX's Zero2 at data 2 x seq 2 under the ring (a file
of its own so that neither file's serial time passes a minute).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import pytest

from test_torch_dropout_dist import check_spawn


@pytest.mark.parametrize("spawn_id", ["data2_seq2"])
def test_engines_drop_rank_invariant_masks(tmp_path, spawn_id):
    check_spawn(tmp_path, spawn_id)
