# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's ZeRO-3 against the JAX `Zero3`, on the CPU over gloo.

Held as tests/test_torch_dist.py holds DDP / ZeRO-1 / ZeRO-2
(`check_against_jax`: the tiny preset in f32, JAX's init crossing
through numpy, 10 steps): the loss trajectory within 1e-4 relative, the
gathered params and optimizer state within 1e-5 (AdamW: on the elements
whose gradient RMS stayed above the roundoff floor; SGD: every element)
and `rank_map` equal to JAX's — at data 2 and at data 2 x seq 2 (ring
attention inside each block, whose gathers run over the data group and
whose gradients SUM over the seq group first).  Also pinned: world-1
`Zero3` bit-equal to `SingleDevice`; the resting layout (per-layer flat
shards of the block leaves); the gathers of one step — each layer's
again in the remat recompute, one reduce-scatter per leaf and layer per
backward; and the refused ZeRO-3 knobs.  tests/test_torch_zero3_knobs.py
adds accumulation, clipping, dynamic loss scaling and SGD.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses

import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.parallel import zero3
from test_torch_dist import _batches, check_against_jax, world1  # noqa: F401


@pytest.mark.parametrize("dp,sp", [(2, 1), (2, 2)], ids=["data2",
                                                         "data2_seq2"])
def test_zero3_matches_jax(tmp_path, dp, sp):
    check_against_jax(tmp_path, "Zero3", dp, sp)


def _run(cls, batches, cfg=None, **kw):
    model = T.GPT2Model(cfg or T.GPT2_PRESETS["tiny"], device="cpu")
    engine = cls(model, T.AdamW(lr=1e-3, weight_decay=0.1), device="cpu",
                 **kw)
    state = engine.init(0)
    losses = [float(engine.step(state, b)[1]) for b in batches]
    return (losses, engine.gather_params(state),
            engine.gather_opt_state(state), engine, state)


@pytest.mark.parametrize("gather_quant", [None, "fp8"])
@pytest.mark.parametrize("accum", [1, 2])
def test_world1_zero3_equals_single_device(world1, accum, gather_quant):
    """At world 1 every gather and reduce-scatter is a copy: losses,
    params and moments bit for bit, with and without the fp8 gather."""
    cfg = dataclasses.replace(T.GPT2_PRESETS["tiny"],
                              gather_quant=gather_quant)
    batches = _batches(3, accum)
    want = _run(T.SingleDevice, batches, cfg, accum_steps=accum)
    got = _run(T.Zero3, batches, cfg, accum_steps=accum)
    assert got[0] == want[0]
    for n, p in want[1].items():
        assert torch.equal(got[1][n], p), n
    for n, slots in want[2]["state"].items():
        for k, t in slots.items():
            assert torch.equal(got[2]["state"][n][k], t), (n, k)


def test_zero3_rests_sharded(world1):
    """The state holds the rank's shards — flat per non-block leaf, (L,
    own) per block leaf — on the optimizer state too; the model's whole
    parameters are released; describe() says so."""
    _, params, _, engine, state = _run(T.Zero3, _batches(1))
    shapes = engine.model.param_shapes()
    for n, p in state.params.items():
        want = ((shapes[n][0], params[n][0].numel()) if n.startswith("h.")
                else (params[n].numel(),))
        assert tuple(p.shape) == want, n
        assert p.dtype == torch.float32
        for t in state.opt_state["state"][n].values():
            assert t.shape == p.shape, n
    assert all(p.numel() == 0 for p in engine.model.parameters())
    assert "params sharded=True" in engine.describe()
    assert engine.rank_map == T.partition_tensors(
        dict(sorted(shapes.items())), 1)


def _count_collectives(monkeypatch):
    calls = {"all_gather": 0, "reduce_scatter": 0}
    ag = zero3.dist.all_gather_into_tensor
    rs = zero3.dist.reduce_scatter_tensor

    def gather(*a, **k):
        calls["all_gather"] += 1
        return ag(*a, **k)

    def scatter(*a, **k):
        calls["reduce_scatter"] += 1
        return rs(*a, **k)

    monkeypatch.setattr(zero3.dist, "all_gather_into_tensor", gather)
    monkeypatch.setattr(zero3.dist, "reduce_scatter_tensor", scatter)
    return calls


@pytest.mark.parametrize("policy,regathers", [
    ("dots_no_batch", True), ("nothing", True), ("all", False)])
def test_zero3_gathers_per_layer_and_again_in_the_recompute(
        world1, monkeypatch, policy, regathers):
    """One step's collectives: the non-block leaves once; each layer's
    twelve block leaves in the forward and, under a remat policy that
    recomputes (the selective "dots_no_batch" saves matmul outputs, not
    gathered weights), again in the backward's recompute; one
    reduce-scatter per leaf (and layer) per backward."""
    cfg = dataclasses.replace(T.GPT2_PRESETS["tiny"], remat_policy=policy)
    model = T.GPT2Model(cfg, device="cpu")
    engine = T.Zero3(model, T.AdamW(lr=1e-3), device="cpu")
    state = engine.init(0)
    calls = _count_collectives(monkeypatch)
    engine.step(state, _batches(1)[0])
    n_block = sum(n.startswith("h.") for n in model.param_shapes())
    n_rest = len(model.param_shapes()) - n_block
    per_pass = n_block * cfg.n_layer
    assert calls == {
        "all_gather": n_rest + per_pass * (2 if regathers else 1),
        "reduce_scatter": n_rest + per_pass}
