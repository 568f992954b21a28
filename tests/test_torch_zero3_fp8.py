# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The backward of ZeRO-3's fp8 weight gather (`GatherFp8Fn`), on the CPU
over gloo: the codes' cotangent g * scale SUMmed over the seq group,
reduce-scattered over the data group, rounded to e4m3 and divided by
each shard element's channel scale.

Without a loss scale that cotangent underflows to zero at the tiny
preset's widths (tests/test_torch_fp8_gather.py), so a backward that
returned zeros would pass a plain loss comparison.  Here it is not zero:

- one step under a static loss scale of 2^20 at data 2 and at data 2 x
  seq 2: the first moment m = (1 - b1) g of every leaf against JAX's
  `Zero3`, under decoupled AdamW (the default folds weight decay into m).
  More than 80% of the quantized weights' m elements are non-zero (the
  rest still underflow), and at least 99.9% equal JAX's to 1e-6 relative:
  the two forwards start from the same masters, so the e4m3 cotangents
  agree but for one that roundoff puts on the other side of a rounding
  tie, which differs by one e4m3 step (1/8; measured: 1 element of 32768
  at data 2).  Not bit for bit: about half the elements differ from
  JAX's in the last bit or two, from the division by the scale and the
  moment's product;
- ten such steps through `check_against_jax`: losses within 1e-4
  relative, params and optimizer state within 5e-4 on the held
  elements.  Measured on the CPU: 2.32e-4 at most (params), 8.6e-5 (m);
  84-95% of the quantized weights' m elements still equal JAX's to 1e-6
  of their largest.  The rest differ because a forward code that flips at
  a rounding tie (tests/test_torch_fp8_gather.py) moves the later
  gradients by more than roundoff, and their e4m3 cotangents round to
  other codes;
- the gather's backward alone at data 3 x seq 2, where no shard starts
  on a row of the weight (data 2 splits every tiny weight on a row): each
  rank's shard gradient equals `fp8_cotangent` of the whole cotangent on
  that rank's slice, bit for bit, when only rank 0 contributes — so the
  SUMs are exact, and a rank of seq 1 gets the gradient only through the
  seq SUM.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models.gpt2 import fp8_cotangent
from test_torch_dist import LR, _batches, check_against_jax
from test_torch_ring import spawn

FP8 = dict(gather_quant="fp8")
QUANT = ("attn.qkv.w", "attn.proj.w", "mlp.fc.w", "mlp.proj.w")
SCALE = 2 ** 20
MESHES = pytest.mark.parametrize("dp,sp", [(2, 1), (2, 2)],
                                 ids=["data2", "data2_seq2"])


def _tiny_fp8():
    return T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **FP8),
                       device="cpu")


def _first_step_worker(rank, world, store, out_dir, sp):
    """One gloo rank: one fp8 Zero3 step under the static loss scale from
    JAX's init; rank 0 saves every leaf's first moment."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        engine = T.Zero3(_tiny_fp8(), T.AdamW(lr=LR, weight_decay=0.1,
                                              decoupled=True),
                         device="cpu", seq_parallel=sp, loss_scale=SCALE)
        state = engine.init(0)
        ref = np.load(os.path.join(out_dir, "params.npz"))
        engine.load_params(state, T.params_from_numpy(dict(ref), "cpu"))
        state, _ = engine.step(state, _batches(1)[0])
        m = {n: s["m"] for n, s in
             engine.gather_opt_state(state)["state"].items()}
        if rank == 0:
            torch.save(m, os.path.join(out_dir, "m.pt"))
    finally:
        dist.destroy_process_group()


def _jax_first_step(dp, sp):
    """JAX's fp8 `Zero3` on a (data[, seq]) CPU mesh: (params at init,
    every leaf's first moment after one step)."""
    import jax
    import jax.numpy as jnp
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
    from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2
    shape, names = ((dp, sp), ("data", "seq")) if sp > 1 else ((dp,),
                                                               ("data",))
    mesh = J.make_mesh(shape, names, devices=jax.devices()[:dp * sp])
    jeng = J.Zero3(JGPT2(dataclasses.replace(JP["tiny"], **FP8)),
                   J.AdamW(lr=LR, weight_decay=0.1, decoupled=True),
                   mesh=mesh,
                   loss_scale=SCALE)
    state = jeng.init(jax.random.PRNGKey(0))
    init = {n: np.asarray(p) for n, p in state.params.items()}
    x, y = _batches(1)[0]
    state, _ = jeng.step(state, (jnp.asarray(x), jnp.asarray(y)))
    return init, {n: np.asarray(s["m"])
                  for n, s in state.opt_state["state"].items()}


@MESHES
def test_zero3_fp8_first_step_grads_match_jax(tmp_path, dp, sp):
    init, want = _jax_first_step(dp, sp)
    np.savez(tmp_path / "params.npz", **init)
    spawn(_first_step_worker, dp * sp, tmp_path, sp)
    got = {n: m.numpy() for n, m in torch.load(tmp_path / "m.pt").items()}
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        if n[2:] in QUANT:
            assert np.count_nonzero(w) > 0.8 * w.size, n
            assert np.mean(np.isclose(g, w, rtol=1e-6, atol=0)) >= 0.999, n
            # a cotangent on the other side of a tie: one e4m3 step
            np.testing.assert_allclose(g, w, rtol=0.125,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=n)


@MESHES
def test_zero3_fp8_matches_jax_under_loss_scale(tmp_path, dp, sp):
    res, jstate, *_ = check_against_jax(
        tmp_path, "Zero3", dp, sp, dict(loss_scale=SCALE), model_kw=FP8,
        atol=5e-4)
    for name in QUANT:
        m = res["opt"]["state"]["h." + name]["m"].numpy()
        assert np.count_nonzero(m) > 0.9 * m.size, name


def _backward_worker(rank, world, store, out_dir):
    """One gloo rank of a data-3 x seq-2 fp8 Zero3: gather each layer's
    quantized weights from its shards of the saved masters and pull the
    saved cotangent through them (rank 0 only; the others pull zeros);
    save the shards' gradients."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        engine = T.Zero3(_tiny_fp8(), T.AdamW(), device="cpu",
                         seq_parallel=2)
        z3 = engine.pctx.gather
        data = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        shards = {n: z3.shard(n, torch.from_numpy(data[n])).clone()
                  .requires_grad_() for n in ("h." + q for q in QUANT)}
        _, stacked = z3.prepare(shards)
        total = 0.0
        for layer in range(z3.n_layer):
            w = z3.layer({k: v[layer] for k, v in stacked.items()})
            for name in QUANT:
                g = torch.from_numpy(data["g." + name][layer])
                total = total + (w[name] * (g if rank == 0 else 0 * g)).sum()
        total.backward()
        torch.save({n: s.grad for n, s in shards.items()},
                   os.path.join(out_dir, f"grad{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_gather_fp8_backward_on_unaligned_shards(tmp_path):
    rng = np.random.default_rng(4)
    model = _tiny_fp8()
    shapes = {n: tuple(s) for n, s in model.param_shapes().items()}
    masters = {n: (rng.standard_normal(s) * 0.02).astype(np.float32)
               for n, s in shapes.items()}
    stacked = model.stacked_compute_params(
        T.params_from_numpy(masters, "cpu"))
    inputs = {"h." + q: masters["h." + q] for q in QUANT}
    want = {}
    for q in QUANT:
        scale = stacked[q + "#scale"]
        # codes' cotangents ~ N(0, 50^2): mostly in e4m3's range, a few
        # past 464 (NaN, as XLA converts)
        g = (rng.standard_normal(shapes["h." + q]) * 50
             / scale.numpy()).astype(np.float32)
        inputs["g." + q] = g
        want["h." + q] = fp8_cotangent(torch.from_numpy(g), scale,
                                       torch.float32).reshape(
                                           scale.shape[0], -1).numpy()
    np.savez(tmp_path / "inputs.npz", **inputs)
    spawn(_backward_worker, 6, tmp_path)
    for rank in range(6):
        d = rank // 2  # rank = data rank * seq size + seq rank
        got = torch.load(tmp_path / f"grad{rank}.pt")
        for n, w in want.items():
            size = w.shape[1]
            s = -(-size // 3)
            assert s % shapes[n][-1] != 0, n  # shards split rows
            lo, hi = min(d * s, size), min((d + 1) * s, size)
            part = w[:, lo:hi]
            assert np.count_nonzero(part) > 0.5 * part.size, n
            assert np.isfinite(part).mean() > 0.99, n
            np.testing.assert_array_equal(got[n].numpy(), part,
                                          err_msg=f"{n} rank {rank}")
