# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Checkpoints of an engine with the grad-comm codec's error feedback
(utils/checkpoint.py), on the CPU over gloo at data 2 (one spawn of two
ranks):

- DDP int8 ("quant_mono"): 6 steps straight, and 3 steps + save + a
  fresh engine loaded + 3 steps — losses, params, AdamW state, step and
  every rank's residual row bit for bit the straight run's (the dither's
  stream is a function of the step and the rank, so a resumed run draws
  what the straight one drew); each rank's file holds its own row;
- a checkpoint without a residual (the same DDP at fp32) resumes under
  int8 with a zero row of the engine's length, as JAX's restore does
  (utils/checkpoint.py:277-290 there), and trains on;
- a residual of another length (`grad_comm_block=4096`) is refused.
"""

import os

import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.utils import checkpoint as ck
from test_torch_checkpoint import _assert_same, _batches, _snapshot
from test_torch_ring import spawn

LR, STEPS, SPLIT = 1e-3, 6, 3


def _ddp(**kw):
    model = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    return T.DDP(model, T.AdamW(lr=LR, weight_decay=0.1), device="cpu",
                 **kw)


def _rows(state, world):
    import torch.distributed as dist
    rows = [torch.empty_like(state.grad_residual) for _ in range(world)]
    dist.all_gather(rows, state.grad_residual)
    return torch.stack(rows)


def _worker(rank, world, store, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        batches = _batches(STEPS, b=4)
        int8 = dict(grad_comm="int8")
        eng = _ddp(**int8)
        state = eng.init(0)
        ref = [float(eng.step(state, b)[1]) for b in batches]
        want, want_res = _snapshot(eng, state), _rows(state, world)

        eng = _ddp(**int8)
        state = eng.init(0)
        got = [float(eng.step(state, b)[1]) for b in batches[:SPLIT]]
        d = os.path.join(out_dir, "int8")
        ck.save_checkpoint(d, state, SPLIT)
        at_split = state.grad_residual.clone()
        eng = _ddp(**int8)
        state = ck.load_checkpoint(d, eng)
        assert torch.equal(state.grad_residual, at_split)
        got += [float(eng.step(state, b)[1]) for b in batches[SPLIT:]]
        _assert_same(_snapshot(eng, state), want)
        assert got == ref, (got, ref)
        assert torch.equal(_rows(state, world), want_res)

        # no residual in the checkpoint: zeros of the engine's length
        eng = _ddp()
        state = eng.init(0)
        for b in batches[:SPLIT]:
            eng.step(state, b)
        assert state.grad_residual is None
        d32 = os.path.join(out_dir, "fp32")
        ck.save_checkpoint(d32, state, SPLIT)
        eng = _ddp(**int8)
        state = ck.load_checkpoint(d32, eng)
        n = eng._schedule.residual_len
        assert n > 0 and torch.equal(state.grad_residual, torch.zeros(n))
        after = [float(eng.step(state, b)[1]) for b in batches[SPLIT:]]
        assert state.grad_residual.abs().max() > 0
        # an engine without error feedback drops a saved row
        eng = _ddp(grad_comm="int8", grad_comm_error_feedback=False)
        assert ck.load_checkpoint(d, eng).grad_residual is None
        # a row of another length does not fit
        with pytest.raises(ValueError, match="grad_residual"):
            ck.load_checkpoint(d, _ddp(grad_comm="int8",
                                       grad_comm_block=4096))
        if rank == 0:
            torch.save({"losses": got, "after_zero_resume": after,
                        "residual_len": n, "rows": want_res},
                       os.path.join(out_dir, "result.pt"))
        dist.barrier()  # no rank tears its groups down before the rest
    finally:
        dist.destroy_process_group()


def test_int8_ddp_data2_resume_bitwise_residual_included(tmp_path):
    spawn(_worker, 2, tmp_path, timeout=240)
    out = torch.load(tmp_path / "result.pt")
    assert out["rows"].shape == (2, out["residual_len"])
    # each rank's file holds its own row, and the rows differ (each
    # rank's own gradient's error)
    rows = [torch.load(tmp_path / "int8" / "step_00000003" /
                       f"rank_0000{r}.pt", weights_only=True)["grad_residual"]
            for r in range(2)]
    assert all(r.shape == (out["residual_len"],) for r in rows)
    assert not torch.equal(rows[0], rows[1])
    assert all(torch.isfinite(torch.tensor(out["after_zero_resume"])))
