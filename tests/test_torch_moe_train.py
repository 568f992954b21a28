# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's MoE training against the JAX package's, on the CPU.

The f32 MoE config of tests/test_torch_moe.py (2 layers, 4 heads, n_embd
32, 4 experts, top-2), the JAX engine's initial weights crossing to the
port through numpy.  Pinned here: 20-step SingleDevice AdamW(lr=1e-3,
wd=0.1) loss trajectories within 1e-4 relative of the JAX
`SingleDevice`'s at every step, for both dispatches, under remat
"dots_no_batch" and "nothing", with the fused head (`fused_xent_impl=
"pallas"`; JAX runs it as the chunked head off a TPU) and with
`AdamW(fused=True)` (JAX's falls back to its XLA update off a TPU; the
port's runs the kernel's plain version on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tiny_deepspeed_tpu import AdamW as JAdamW
from tiny_deepspeed_tpu import SingleDevice as JSingleDevice
from tiny_deepspeed_tpu import make_mesh
from tiny_deepspeed_tpu.models import moe as JM
import tiny_deepspeed_tpu_torch as T
from test_torch_moe import _np, configs


@pytest.mark.filterwarnings("ignore:AdamW\\(fused=True\\) falling back")
@pytest.mark.parametrize("cfg,fused", [
    (dict(remat_policy="dots_no_batch"), False),
    (dict(moe_dispatch="sort", remat_policy="nothing"), False),
    (dict(fused_xent=True, fused_xent_impl="pallas"), False),
    (dict(moe_dispatch="sort"), True),
], ids=["einsum-dots_no_batch", "sort-nothing", "einsum-pallas-head",
        "sort-fused-adamw"])
def test_20_step_trajectory_matches_jax(cfg, fused):
    jcfg, tcfg = configs(**cfg)
    jeng = JSingleDevice(JM.MoEGPT(jcfg),
                         JAdamW(lr=1e-3, weight_decay=0.1, fused=fused),
                         mesh=make_mesh(devices=[jax.devices()[0]]))
    jstate = jeng.init(jax.random.PRNGKey(0))
    pm = T.MoEGPT(tcfg, device="cpu")
    teng = T.SingleDevice(pm, T.AdamW(lr=1e-3, weight_decay=0.1,
                                      fused=fused), device="cpu")
    tstate = teng.init(0)
    pm.load_state_dict(T.params_from_numpy(_np(jstate.params), "cpu"))
    loader = T.TokenLoader(None, 2, 32, vocab_size=128, seed=3)
    jl, tl = [], []
    for _ in range(20):
        x, y = loader.next()
        jstate, loss = jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))
        tstate, loss = teng.step(tstate, (x, y))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert all(np.isfinite(tl))
