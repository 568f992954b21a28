# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's distributed engines on `LlamaModel` against the JAX
package's, on the CPU over gloo.

The JAX package's tiny Llama test config (2 layers, 4 query heads over 2
kv heads, n_embd 32, vocab 128, f32) is initialised from a seed and its
weights cross to the port through numpy.  Each port engine runs on
spawned gloo processes, every rank stepping on the same global batches;
the JAX engine of the same stage runs on a CPU mesh of the same layout.
Pinned here, over 10 AdamW steps:

- ZeRO-2 at data 2 x seq 2: ring attention over the seq groups with the
  K/V at kv_heads, and RoPE at the rank's global positions (seq_rank *
  Tl onwards);
- ZeRO-3 at data 2: the per-layer gathers over Llama's names;

loss trajectories within 1e-4 relative of JAX's, the rank map equal to
JAX's, and the gathered params within 1e-3 (Adam's normalized step turns
roundoff of near-zero gradients into up to a step of lr = 1e-3).  At
world 1 Zero2 and Zero3 (also with the fp8 gather, which quantizes
Llama's seven block products) are bit for bit SingleDevice.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import llama as TL
from test_torch_dist import world1  # noqa: F401
from test_torch_ring import spawn

B, SEQ, STEPS, LR = 4, 32, 10, 1e-3
_CFG = dict(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_kv_head=2,
            n_embd=32)


def _batches(n):
    loader = T.TokenLoader(None, B, SEQ, vocab_size=128, seed=3)
    return [loader.next() for _ in range(n)]


def _worker(rank, world, store, out_dir, name, sp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        model = T.LlamaModel(TL.LlamaConfig(compute_dtype=torch.float32,
                                            **_CFG), device="cpu")
        engine = getattr(T, name)(model, T.AdamW(lr=LR, weight_decay=0.1),
                                  device="cpu", seq_parallel=sp)
        state = engine.init(0)
        ref = np.load(os.path.join(out_dir, "params.npz"))
        engine.load_params(state, T.params_from_numpy(dict(ref), "cpu"))
        losses = []
        for batch in _batches(STEPS):
            state, loss = engine.step(state, batch)
            losses.append(float(loss))
        params = engine.gather_params(state)
        if rank == 0:
            torch.save({"losses": losses, "params": params,
                        "rank_map": engine.rank_map},
                       os.path.join(out_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,dp,sp", [("Zero2", 2, 2), ("Zero3", 2, 1)],
                         ids=["zero2-data2-seq2", "zero3-data2"])
def test_engine_matches_jax(tmp_path, name, dp, sp):
    import jax
    import jax.numpy as jnp
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models import llama as JL
    from tiny_deepspeed_tpu.parallel.partition import partition_tensors
    shape, names = ((dp, sp), ("data", "seq")) if sp > 1 else ((dp,),
                                                               ("data",))
    mesh = J.make_mesh(shape, names, devices=jax.devices()[:dp * sp])
    jeng = getattr(J, name)(
        JL.LlamaModel(JL.LlamaConfig(compute_dtype=jnp.float32, **_CFG)),
        J.AdamW(lr=LR, weight_decay=0.1), mesh=mesh)
    state = jeng.init(jax.random.PRNGKey(0))
    np.savez(tmp_path / "params.npz",
             **{n: np.asarray(p) for n, p in state.params.items()})
    jl = []
    for x, y in _batches(STEPS):
        state, loss = jeng.step(state, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))
    spawn(_worker, dp * sp, tmp_path, name, sp, timeout=180)
    res = torch.load(tmp_path / "result.pt")
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-4)
    assert res["losses"][-1] < res["losses"][0]
    assert res["rank_map"] == jeng.rank_map == partition_tensors(
        jeng.model.param_shapes(), dp)
    for n, p in res["params"].items():
        np.testing.assert_allclose(p.numpy(), np.asarray(state.params[n]),
                                   atol=1e-3, err_msg=n)


@pytest.mark.parametrize("name,gather_quant", [
    ("Zero2", None), ("Zero3", None), ("Zero3", "fp8")],
    ids=["zero2", "zero3", "zero3-fp8"])
def test_world1_engine_equals_single_device(world1, name, gather_quant):
    """At world 1 every collective is a copy: losses and params bit for
    bit SingleDevice's over 3 steps."""
    cfg = TL.LlamaConfig(compute_dtype=torch.float32,
                         gather_quant=gather_quant, **_CFG)
    out = []
    for cls in (T.SingleDevice, getattr(T, name)):
        engine = cls(T.LlamaModel(cfg, device="cpu"),
                     T.AdamW(lr=LR, weight_decay=0.1), device="cpu")
        state = engine.init(0)
        losses = [float(engine.step(state, b)[1]) for b in _batches(3)]
        out.append((losses, engine.gather_params(state)))
    assert out[1][0] == out[0][0]
    for n, p in out[0][1].items():
        assert torch.equal(out[1][1][n], p), n
