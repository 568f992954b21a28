# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Tensor parallelism (the "model" axis) of the port's engines against
the JAX engines, on the CPU over gloo: one spawn of 4 ranks.

Each case runs the port engine on gloo ranks laid out (data, seq, model)
and the JAX engine of the same stage on a CPU mesh of that shape, from
the same init, over 10 steps of the same global batches, and compares
them as tests/test_torch_dist.py does (`check_case`: losses within 1e-4
relative, the gathered params and optimizer state at 1e-5 where the
gradient is not roundoff, 99% of the elements so held; the fp8 ZeRO-3
gather at 2e-4, its tolerance in tests/test_torch_zero3_fp8.py):

- DDP, Zero1, Zero2 and Zero3 at data 2 x tp 2 (GPT-2 `tiny`, f32);
- DDP at tp 4 (`tiny` with 4 heads: one head a rank);
- Zero2 at tp 2 x seq 2 under the ring and under Ulysses (4 heads: the
  rank's 2 heads split over the seq group), Zero3 under the ring;
- Llama (`llama-tiny`: 4 query heads over 2 K/V heads, 2 and 1 a rank)
  under Zero2 and Zero3 at data 2 x tp 2, and Zero2 at tp 2 x seq 2
  under Ulysses (the rank's one K/V head expanded for the all-to-all);
- Zero3 with the fp8 gather at data 2 x tp 2 (a row-parallel leaf's
  scale is a MAX over the model group too);
- Zero2 at data 2 x tp 2 with grad clipping and the telemetry in layers
  mode (SGD): each step's health vector and (n_layer, 6) matrix within
  1e-5 relative of JAX's — a cut leaf counted across the model group, a
  replicated one once;
- Zero2 at data 2 x tp 2 accumulating 2 microbatches, and Zero1 under a
  dynamic loss scale whose first steps overflow (the same steps skipped
  as JAX's, the scale halved as often).

In the same spawn, without JAX:

- dropout 0.1 under Zero2 at data 2 x tp 2: the losses within 1e-5 of
  SingleDevice's on the same global batches, and every mask the same on
  the two model ranks of a data rank (each site sits after a reduce, at
  full width, and its frame is the data x seq block);
- Zero3 at data 2 x tp 2, 5 steps + save + load into a fresh engine + 5
  steps: bit for bit the straight 10 of the `zero3` case; the
  checkpoint's `load_params` joins every rank's shards and pieces into
  JAX's logical layout, bit for bit that case's gathered params (so
  within the case's tolerance of JAX's); another layout (data 4) is
  refused by the load.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
from tiny_deepspeed_tpu_torch.utils import checkpoint as ck
from test_torch_dist import (STEPS, _batches, _jax_run, _optimizer,
                             _run_config, check_case, check_health)
from test_torch_ring import spawn

TP2 = dict(tensor_parallel=2)
H4 = dict(n_head=4)
CASES = {
    "ddp": dict(name="DDP", dp=2, sp=1, kw=TP2),
    "zero1": dict(name="Zero1", dp=2, sp=1, kw=TP2),
    "zero2": dict(name="Zero2", dp=2, sp=1, kw=TP2),
    "zero3": dict(name="Zero3", dp=2, sp=1, kw=TP2),
    "ddp-tp4": dict(name="DDP", dp=1, sp=1, kw=dict(tensor_parallel=4),
                    model_kw=H4),
    "zero2-seq2-ring": dict(name="Zero2", dp=1, sp=2, kw=TP2),
    "zero2-seq2-ulysses": dict(name="Zero2", dp=1, sp=2,
                               kw=dict(TP2, seq_impl="ulysses"),
                               model_kw=H4),
    "zero3-seq2-ring": dict(name="Zero3", dp=1, sp=2, kw=TP2),
    "llama-zero2": dict(name="Zero2", dp=2, sp=1, kw=TP2,
                        preset="llama-tiny"),
    "llama-zero2-seq2-ulysses": dict(name="Zero2", dp=1, sp=2,
                                     kw=dict(TP2, seq_impl="ulysses"),
                                     preset="llama-tiny"),
    "llama-zero3": dict(name="Zero3", dp=2, sp=1, kw=TP2,
                        preset="llama-tiny"),
    "zero3-fp8": dict(name="Zero3", dp=2, sp=1, kw=TP2,
                      model_kw=dict(gather_quant="fp8")),
    "zero2-clip-layers": dict(name="Zero2", dp=2, sp=1,
                              kw=dict(TP2, grad_clip=0.5), opt="sgd",
                              telemetry="layers"),
    "zero2-accum2": dict(name="Zero2", dp=2, sp=1, kw=TP2, accum=2),
    "zero1-overflow": dict(name="Zero1", dp=2, sp=1,
                           kw=dict(TP2, loss_scale="dynamic"),
                           overflow=True),
}
_DEFAULTS = dict(kw={}, opt="adamw", model_kw=None, preset="tiny",
                 telemetry=None, accum=1, overflow=False)
DROP = 0.1
DROP_STEPS = 4
SPLIT = 5


def _ref_params(out_dir, tag):
    return T.params_from_numpy(
        dict(np.load(os.path.join(out_dir, f"params{tag}.npz"))), "cpu")


def _dropout_run(rank, out_dir):
    """Zero2 at data 2 x tp 2 with dropout: each rank's losses and the
    zero pattern of every dropout site's output, in call order."""
    model = T.build_model(dataclasses.replace(T.ALL_PRESETS["tiny"],
                                              dropout=DROP), device="cpu")
    eng = T.Zero2(model, _optimizer("adamw"), device="cpu", **TP2)
    state = eng.init(0)
    eng.load_params(state, _ref_params(out_dir, "zero2"))
    masks, orig = [], gpt2_mod._dropout

    def recorded(x, key, rate, pctx=None):
        y = orig(x, key, rate, pctx)
        masks.append(y.detach() == 0)
        return y

    gpt2_mod._dropout = recorded
    try:
        losses = [float(eng.step(state, b)[1])
                  for b in _batches(DROP_STEPS)]
    finally:
        gpt2_mod._dropout = orig
    torch.save({"losses": losses, "masks": masks},
               os.path.join(out_dir, f"drop{rank}.pt"))


def _resume_run(rank, out_dir):
    """The `zero3` case's 10 steps as 5 + save + load + 5, then the
    checkpoint refused by a data-4 engine."""
    def engine(**kw):
        return T.Zero3(T.build_model(T.ALL_PRESETS["tiny"], device="cpu"),
                       _optimizer("adamw"), device="cpu", **kw)

    batches = _batches(STEPS)
    eng = engine(**TP2)
    state = eng.init(0)
    eng.load_params(state, _ref_params(out_dir, "zero3"))
    losses = [float(eng.step(state, b)[1]) for b in batches[:SPLIT]]
    d = os.path.join(out_dir, "ckpt")
    ck.save_checkpoint(d, state, SPLIT)
    eng = engine(**TP2)
    state = ck.load_checkpoint(d, eng)
    losses += [float(eng.step(state, b)[1]) for b in batches[SPLIT:]]
    ck.save_checkpoint(d, state, STEPS)
    params = eng.gather_params(state)
    refused = None
    try:
        ck.load_checkpoint(d, engine())
    except ValueError as e:
        refused = str(e)
    if rank == 0:
        torch.save({"losses": losses, "params": params, "refused": refused},
                   os.path.join(out_dir, "resume.pt"))


def _worker(rank, world, store, out_dir, configs):
    """Every JAX-compared case (`test_torch_dist._run_config`), then the
    dropout and resume runs, on one gloo world."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        for c in configs:
            _run_config(rank, out_dir, **c)
            dist.barrier()
        _dropout_run(rank, out_dir)
        dist.barrier()
        _resume_run(rank, out_dir)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's run of every case, then one 4-rank spawn: (out_dir, {id:
    (the port's result, JAX's run, the case)})."""
    tmp = tmp_path_factory.mktemp("tp")
    jax_out, configs = {}, []
    for cid, c in CASES.items():
        c = dict(_DEFAULTS, **c)
        assert c["dp"] * c["sp"] * c["kw"].get("tensor_parallel", 1) == 4
        out = _jax_run(c["name"], c["dp"], c["sp"], c["kw"], c["opt"],
                       c["accum"], c["overflow"], c["model_kw"], c["preset"],
                       c["telemetry"])
        np.savez(tmp / f"params{cid}.npz", **out[0])
        configs.append(dict(name=c["name"], sp=c["sp"], kw=c["kw"],
                            opt=c["opt"], accum=c["accum"],
                            overflow=c["overflow"], model_kw=c["model_kw"],
                            preset=c["preset"], tag=cid,
                            telemetry=c["telemetry"]))
        jax_out[cid] = (out, c)
    spawn(_worker, 4, tmp, configs, timeout=120 + 25 * len(configs))
    return tmp, {cid: (torch.load(tmp / f"result{cid}.pt"), out, c)
                 for cid, (out, c) in jax_out.items()}


@pytest.mark.parametrize("cid", [c for c in CASES
                                 if c != "zero2-clip-layers"])
def test_engine_matches_jax_tp(runs, cid):
    _, got = runs
    # llama-tiny's loss on the random tokens does not fall in 10 steps,
    # JAX's neither (`progress=False` checks that)
    check_case(got, cid, atol=2e-4 if cid == "zero3-fp8" else 1e-5,
               progress=not cid.startswith("llama"))


def test_grad_clip_and_layer_health_match_jax_tp(runs):
    _, got = runs
    res, _, jeng, *_ = check_case(got, "zero2-clip-layers")
    assert jeng._schedule.lowering == res["lowering"] == "probe"
    check_health(res, jeng, "layers", T.GPT2_PRESETS["tiny"].n_layer)


def test_dropout_masks_equal_across_model_ranks(runs):
    """The model ranks of a data rank draw the same masks; the run's
    losses are SingleDevice's on the global batch within 1e-5."""
    tmp, _ = runs
    got = [torch.load(tmp / f"drop{r}.pt") for r in range(4)]
    # rank = d * 2 + m
    for d in range(2):
        a, b = got[2 * d]["masks"], got[2 * d + 1]["masks"]
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert got[2 * d]["losses"] == got[2 * d + 1]["losses"]
    # the data ranks draw different blocks of the global mask
    assert not all(torch.equal(x, y) for x, y in
                   zip(got[0]["masks"], got[2]["masks"]))
    model = T.build_model(dataclasses.replace(T.ALL_PRESETS["tiny"],
                                              dropout=DROP), device="cpu")
    eng = T.SingleDevice(model, _optimizer("adamw"), device="cpu")
    state = eng.init(0)
    eng.load_params(state, _ref_params(tmp, "zero2"))
    want = [float(eng.step(state, b)[1]) for b in _batches(DROP_STEPS)]
    np.testing.assert_allclose(got[0]["losses"], want, rtol=1e-5)


def test_checkpoint_resume_tp_bitwise(runs):
    tmp, got = runs
    res = torch.load(tmp / "resume.pt")
    straight = got["zero3"][0]
    assert res["losses"] == straight["losses"]
    for n, p in straight["params"].items():
        assert torch.equal(res["params"][n], p), n
    step = tmp / "ckpt" / f"step_{STEPS:08d}"
    assert sorted(f for f in os.listdir(step) if f.endswith(".pt")) == [
        f"rank_{r:05d}.pt" for r in range(4)]
    meta = ck.read_meta(str(tmp / "ckpt"), STEPS)
    assert (meta["world"], meta["data_size"], meta["model_size"],
            meta["expert_size"]) == (4, 2, 2, 1)
    whole = ck.load_params(str(tmp / "ckpt"))
    assert set(whole) == set(straight["params"])
    for n, p in straight["params"].items():
        assert torch.equal(whole[n], p), n
    # ... so within the zero3 case's tolerance of JAX's params
    _, jstate = check_case(got, "zero3")[:2]
    np.testing.assert_allclose(whole["h.attn.qkv.w"].numpy(),
                               np.asarray(jstate.params["h.attn.qkv.w"]),
                               atol=1e-3)
    assert "model 2" in res["refused"] and "model 1" in res["refused"]
