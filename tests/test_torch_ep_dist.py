# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Expert parallelism (the "expert" axis) of the port's engines on
`MoEGPT` against the JAX engines, on the CPU over gloo.

The `moe-tiny` preset (4 experts, top-2, f32) runs on the port's gloo
ranks laid out (data, model, expert) and on a JAX CPU mesh of that
shape, from the same init, over 10 steps of the same global batches,
compared as tests/test_torch_dist.py does (`check_case`: losses within
1e-4 relative, the gathered params and optimizer state at 1e-5 where the
gradient is not roundoff):

- DDP at data 2 x ep 2 (two experts a rank) with `moe_dispatch="sort"`,
  which runs the einsum dispatch under EP as JAX's does;
- DDP at ep 4 (one expert a rank) and at ep 2 x tp 2 (each expert's
  hidden dim cut over the model group, the combine reduced over the
  (model x expert) ranks);
- Zero2 and Zero3 at data 2 x ep 2 (the data shards of the rank's
  experts), and Zero3 with the fp8 gather there at 2e-4 (an expert
  leaf's per-channel scale is a MAX over the expert group too);
- DDP at seq 2 x ep 2 (the ring inside each expert rank's attention).

The routing is global on every rank (the same token panel on every
expert rank, JAX's capacity), each expert rank runs its experts' rows of
the dispatched panel, and the replicated router, attention and aux term
are the same on every rank.  One spawn of 4 ranks.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import pytest

from test_torch_dist import check_case, run_cases

MOE = "moe-tiny"
CASES = {
    "ddp-data2-ep2-sort": dict(name="DDP", dp=2, sp=1,
                               kw=dict(expert_parallel=2),
                               model_kw=dict(moe_dispatch="sort")),
    "ddp-ep4": dict(name="DDP", dp=1, sp=1, kw=dict(expert_parallel=4)),
    "ddp-ep2-tp2": dict(name="DDP", dp=1, sp=1,
                        kw=dict(expert_parallel=2, tensor_parallel=2)),
    "zero2-data2-ep2": dict(name="Zero2", dp=2, sp=1,
                            kw=dict(expert_parallel=2)),
    "zero3-data2-ep2": dict(name="Zero3", dp=2, sp=1,
                            kw=dict(expert_parallel=2)),
    "ddp-seq2-ep2": dict(name="DDP", dp=1, sp=2,
                         kw=dict(expert_parallel=2)),
    "zero3-fp8-data2-ep2": dict(name="Zero3", dp=2, sp=1,
                                kw=dict(expert_parallel=2),
                                model_kw=dict(gather_quant="fp8")),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("ep"), {
        cid: dict(c, preset=MOE) for cid, c in CASES.items()})


@pytest.mark.parametrize("cid", list(CASES))
def test_moe_engine_matches_jax_ep(runs, cid):
    # under the fp8 gather moe-tiny's loss does not fall in 10 steps,
    # JAX's neither (`progress=False` checks that)
    fp8 = "fp8" in cid
    check_case(runs, cid, atol=2e-4 if fp8 else 1e-5, progress=not fp8)
