# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's DDP, ZeRO-1 and ZeRO-2 at world 4 (data 2 x seq 2: ring
attention over the seq groups) against the JAX engines on a (data, seq)
CPU mesh, as tests/test_torch_dist.py compares them; `grad_clip` under
ZeRO-2 there; and the torchrun entry point with a sequence split."""

import os
import subprocess
import sys

import pytest

from test_torch_dist import check_case, run_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seq2(tmp_path_factory):
    """Every data 2 x seq 2 case of this file in one 4-rank gloo spawn."""
    cases = {n: dict(name=n, dp=2, sp=2) for n in ("DDP", "Zero1", "Zero2")}
    cases["Zero2-clip"] = dict(name="Zero2", dp=2, sp=2,
                               kw=dict(grad_clip=0.5))
    return run_cases(tmp_path_factory.mktemp("seq2"), cases)


@pytest.mark.parametrize("name", ["DDP", "Zero1", "Zero2"])
def test_engine_matches_jax_data2_seq2(seq2, name):
    check_case(seq2, name)


def test_zero2_grad_clip_matches_jax_data2_seq2(seq2):
    check_case(seq2, "Zero2-clip")


def test_torchrun_zero2_seq2_on_cpu():
    """Two ranks under torchrun (gloo): only rank 0 prints, the JAX CLI's
    lines."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tiny_deepspeed_tpu_torch.train",
         "--device", "cpu", "--model", "tiny", "--engine", "zero2",
         "--seq-parallel", "2", "--iters", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("Zero2(stage=2, devices=2, accum=1")
    assert lines[1] == "model=tiny params=0.2M global_batch=2 T=256"
    assert [ln.split()[:2] for ln in lines if " loss " in ln] == [
        ["iter", "0"], ["iter", "1"], ["iter", "2"]]
    assert lines[-1].startswith("done: 3 iters in ")
    assert "tokens/s" in lines[-1] and len(lines) == 6
