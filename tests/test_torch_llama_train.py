# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's Llama training against the JAX package's, on the CPU.

The tiny f32 configs of tests/test_torch_llama.py (groups 2 and 3), the
JAX engine's initial weights crossing to the port through numpy.
Pinned here:

- 20-step SingleDevice AdamW(lr=1e-3, wd=0.1) trajectories within 1e-4
  relative of the JAX `SingleDevice`'s at every step, under remat
  "nothing" / "dots_no_batch" and under the chunked and pallas heads
  (JAX runs "pallas" as the chunked head off a TPU);
- `python -m tiny_deepspeed_tpu_torch.train --model llama-tiny` on the
  CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tiny_deepspeed_tpu import AdamW as JAdamW
from tiny_deepspeed_tpu import SingleDevice as JSingleDevice
from tiny_deepspeed_tpu import make_mesh
from tiny_deepspeed_tpu.models import llama as JL
import tiny_deepspeed_tpu_torch as T
from test_torch_llama import _np, configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engines(name, cfg):
    jcfg, tcfg = configs(name, **cfg)
    jeng = JSingleDevice(JL.LlamaModel(jcfg),
                         JAdamW(lr=1e-3, weight_decay=0.1),
                         mesh=make_mesh(devices=[jax.devices()[0]]))
    jstate = jeng.init(jax.random.PRNGKey(0))
    pm = T.LlamaModel(tcfg, device="cpu")
    teng = T.SingleDevice(pm, T.AdamW(lr=1e-3, weight_decay=0.1),
                          device="cpu")
    tstate = teng.init(0)
    pm.load_state_dict(T.params_from_numpy(_np(jstate.params), "cpu"))
    return jeng, jstate, teng, tstate


@pytest.mark.parametrize("name,cfg", [
    ("g2", dict(remat_policy="nothing")),
    ("g2", dict(remat_policy="dots_no_batch")),
    ("g2", dict(fused_xent=True, fused_xent_impl="chunked")),
    ("g2", dict(fused_xent=True, fused_xent_impl="pallas")),
    ("g3", dict(remat_policy="dots_no_batch")),
], ids=["g2-nothing", "g2-dots_no_batch", "g2-chunked", "g2-pallas",
        "g3-dots_no_batch"])
def test_20_step_trajectory_matches_jax(name, cfg):
    jeng, jstate, teng, tstate = _engines(name, cfg)
    loader = T.TokenLoader(None, 2, 32, vocab_size=128, seed=3)
    jl, tl = [], []
    for _ in range(20):
        x, y = loader.next()
        jstate, loss = jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))
        tstate, loss = teng.step(tstate, (x, y))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_train_module_runs_llama_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tiny_deepspeed_tpu_torch.train",
         "--device", "cpu", "--model", "llama-tiny", "--iters", "3",
         "--seq-len", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("SingleDevice")
    assert lines[1] == "model=llama-tiny params=0.2M global_batch=1 T=32"
    assert [ln.split()[:2] for ln in lines if " loss " in ln] == [
        ["iter", "0"], ["iter", "1"], ["iter", "2"]]
    assert lines[-1].startswith("done: 3 iters in ")
