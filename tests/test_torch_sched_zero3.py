# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""ZeRO-3's scheduled gathers and the composed schedule
(parallel/schedule.py) against JAX's `Zero3`, on the CPU over gloo.

Held as tests/test_torch_sched.py holds its cases (`check_against_jax`:
tiny f32 at 4 layers, 10 AdamW steps, loss 1e-4 relative, params and
optimizer state 1e-5, fp8 2e-4; the lowering equal to JAX's):

- `gather_prefetch=2, gather_groups=2` under the fp8 gather at data 4
  ("prefetch", the 2-hop gather: hop 1 moves the e4m3 codes within
  pairs of ranks, hop 2 the dequantized weights across the pairs);
- `hpz=True` over two granules of two ranks at data 4 ("composed": one
  inter-granule gather of the replica a step, every layer gather within
  the granule, the gradients back in the global shards);
- hpZ with `gather_prefetch=2` and `grad_buckets=2` at data 4
  ("composed");
- `grad_buckets=2` under the fp8 gather at data 2 ("composed" through
  the implicit on-demand gather slot: each rank's e4m3 cotangents,
  XLA's float8 pmean, the stacked cast's pullback once) — without a
  loss scale, where the quantized weights' cotangents underflow to zero
  at these widths (tests/test_torch_zero3_fp8.py), and under a static
  2^20, where they do not: more than 90% of those weights' first moments
  are non-zero and the case still holds at 2e-4 (measured on the CPU:
  the moments within 4e-9 of JAX's).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import numpy as np
import pytest

from test_torch_dist import check_case, run_cases

L4 = {"n_layer": 4}
FP8 = dict(L4, gather_quant="fp8")
GRAN = {0: 0, 1: 0, 2: 1, 3: 1}


CASES = {
    "data4-2hop-fp8": (4, dict(gather_prefetch=2, gather_groups=2), FP8,
                       2e-4, "prefetch"),
    "data4-hpz": (4, dict(hpz=True, hpz_granule_of=GRAN), L4, 1e-5,
                  "composed"),
    "data4-hpz-prefetch2-buckets2": (4, dict(hpz=True, hpz_granule_of=GRAN,
                                             gather_prefetch=2,
                                             grad_buckets=2), L4, 1e-5,
                                     "composed"),
    "data2-buckets2-fp8": (2, dict(grad_buckets=2), FP8, 2e-4, "composed"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of this file: one gloo spawn a world size (4 and 2)."""
    cases = {cid: dict(name="Zero3", dp=dp, sp=1, kw=kw, model_kw=model_kw)
             for cid, (dp, kw, model_kw, _, _) in CASES.items()}
    cases["loss-scale"] = dict(name="Zero3", dp=2, sp=1,
                               kw=dict(grad_buckets=2, loss_scale=2 ** 20),
                               model_kw=FP8)
    return run_cases(tmp_path_factory.mktemp("sched_zero3"), cases)


@pytest.mark.parametrize("case", list(CASES))
def test_zero3_schedule_matches_jax(runs, case):
    *_, atol, lowering = CASES[case]
    res, _, jeng, *_ = check_case(runs, case, atol=atol)
    assert jeng._schedule.lowering == res["lowering"] == lowering


def test_zero3_composed_fp8_matches_jax_under_loss_scale(runs):
    res, _, jeng, *_ = check_case(runs, "loss-scale", atol=2e-4)
    assert jeng._schedule.lowering == res["lowering"] == "composed"
    for name in ("attn.qkv.w", "attn.proj.w", "mlp.fc.w", "mlp.proj.w"):
        m = res["opt"]["state"]["h." + name]["m"].numpy()
        assert np.count_nonzero(m) > 0.9 * m.size, name
