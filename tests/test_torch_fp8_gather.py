# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's fp8 weight gather (`GPTConfig(gather_quant="fp8")`) against
the JAX package's, on the CPU.

Pinned:

- the stacked e4m3 codes and f32 scales bit-identical to JAX's
  `stacked_compute_params` on the same masters — whole (one device) and
  as ZeRO-3 quantizes them, each rank its own flat shard after an
  all-reduce MAX of the channel absmax (data 3, so shards split rows);
- the cotangent: `fp8_cotangent` equals `jax.vjp` of JAX's quantize /
  dequantize chain, in f32 and bf16, NaN where XLA's e4m3 conversion
  overflows (torch's cast saturates); and one step's gradients under a
  2^20 loss scale (so the e4m3 cotangents do not underflow) equal
  `jax.grad`'s on the block weights — all but the odd element whose code
  the two forwards' roundoff puts on the other side of a rounding tie;
- 10-step loss trajectories of `SingleDevice` and of `Zero3` at data 2
  within 1e-4 of JAX's.  Without a loss scale the block weights' e4m3
  cotangent underflows to zero in both packages at these widths (their
  dW x scale lies far below e4m3's least subnormal, 2^-9), so those
  weights move by weight decay alone (tests/test_torch_zero3_fp8.py
  holds ZeRO-3's fp8 backward under a loss scale).  The gathered params and optimizer
  state are held as tests/test_torch_dist.py holds them, but to 2e-4,
  not 1e-5: the masters agree to roundoff, yet a master lying on a
  rounding tie of its code flips to the neighbouring code, which moves
  that weight by a whole e4m3 step in the forward, and Adam carries the
  changed gradients of the other leaves into their params.
  `test_zero3_fp8_matches_jax_data2` prints the gap (pytest -s): on the
  CPU 80 of 98304 codes differ from JAX's after 10 steps, the held
  params by up to 6.03e-5, the losses by 6.87e-7 (relative);
- a 30-step curve within 5% of the unquantized one, which still trains,
  as JAX's tests/test_fp8_gather.py holds it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models.gpt2 import fp8_cotangent
from test_torch_dist import RMS_FLOOR, _batches, check_against_jax
from test_torch_ring import spawn

FP8 = dict(gather_quant="fp8")
QUANT = ("attn.qkv.w", "attn.proj.w", "mlp.fc.w", "mlp.proj.w")


def _masters(kind):
    """JAX's tiny init, or seeded numpy masters spanning many binades (so
    the codes reach e4m3's subnormals and its top)."""
    import jax
    from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
    from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2
    jm = JGPT2(dataclasses.replace(JP["tiny"], **FP8))
    p = {n: np.asarray(v) for n, v in jm.init(jax.random.PRNGKey(0)).items()}
    if kind == "wide":
        rng = np.random.default_rng(1)
        p = {n: (rng.standard_normal(v.shape)
                 * 10.0 ** rng.uniform(-6, 2, v.shape)).astype(np.float32)
             for n, v in p.items()}
    return jm, p


def _jax_stacked(jm, p):
    import jax.numpy as jnp
    st = jm.stacked_compute_params({n: jnp.asarray(v) for n, v in p.items()})
    return {k: np.asarray(v) for k, v in st.items()}


@pytest.mark.parametrize("kind", ["init", "wide"])
def test_stacked_codes_and_scales_match_jax(kind):
    jm, p = _masters(kind)
    want = _jax_stacked(jm, p)
    tm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **FP8),
                     device="cpu")
    got = tm.stacked_compute_params(T.params_from_numpy(p, "cpu"))
    for name in QUANT:
        assert got[name].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            got[name].view(torch.uint8).numpy(),
            want[name].view(np.uint8), err_msg=name)
        np.testing.assert_array_equal(
            got[name + "#scale"].numpy().view(np.uint32),
            want[name + "#scale"].view(np.uint32), err_msg=name)
    assert set(got) - set(want) == {n + "#master" for n in QUANT}
    for name, v in want.items():
        if "#" not in name and name not in QUANT:
            np.testing.assert_array_equal(got[name].numpy(), v)


def _shard_codes_worker(rank, world, store, out_dir):
    """One gloo rank of a data-3 Zero3: quantize its shards of the saved
    masters; rank 0 saves the whole codes and scales."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        model = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                                **FP8), device="cpu")
        engine = T.Zero3(model, T.AdamW(), device="cpu")
        z3 = engine.pctx.gather
        masters = T.params_from_numpy(
            dict(np.load(os.path.join(out_dir, "masters.npz"))), "cpu")
        shards = {n: z3.shard(n, v) for n, v in masters.items()}
        _, stacked = z3.prepare(shards)
        out = {}
        for name in QUANT:
            codes = z3.whole("h." + name, stacked[name])
            out[name] = codes.view(torch.uint8)
            out[name + "#scale"] = stacked[name + "#scale"]
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


def test_zero3_shard_codes_match_jax(tmp_path):
    jm, p = _masters("wide")
    np.savez(tmp_path / "masters.npz", **p)
    spawn(_shard_codes_worker, 3, tmp_path)
    got = torch.load(tmp_path / "result.pt")
    want = _jax_stacked(jm, p)
    for name in QUANT:
        np.testing.assert_array_equal(got[name].numpy(),
                                      want[name].view(np.uint8),
                                      err_msg=name)
        np.testing.assert_array_equal(
            got[name + "#scale"].numpy().view(np.uint32),
            want[name + "#scale"].view(np.uint32), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cotangent_matches_jax_vjp(dtype):
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((3, 16, 8)) * 0.05).astype(np.float32)
    s = np.abs(w).max(axis=1, keepdims=True) / 448.0 + 1e-12
    g = (rng.standard_normal(w.shape)
         * rng.choice([1e-3, 1.0, 1e3, 1e6], w.shape)).astype(np.float32)
    cd = getattr(jnp, dtype)

    def chain(v):
        return ((v / s).astype(jnp.float8_e4m3fn).astype(cd)
                * jnp.asarray(s).astype(cd))

    _, vjp = jax.vjp(chain, jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g).astype(cd))
    want = np.asarray(want)
    tcd = getattr(torch, dtype)
    got = fp8_cotangent(torch.from_numpy(g).to(tcd), torch.from_numpy(s),
                        tcd).numpy()
    assert np.isnan(want).sum() > 0  # the overflow case is exercised
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin], want[fin])


def test_fp8_grads_match_jax_under_loss_scale():
    import jax
    import jax.numpy as jnp
    jm, p = _masters("init")
    rng = np.random.default_rng(0)
    idx, tgt = (rng.integers(0, 512, (2, 32)) for _ in range(2))
    scale = 2.0 ** 20
    jg = jax.grad(lambda q: scale * jm.apply(q, jnp.asarray(idx),
                                             jnp.asarray(tgt)))(
        {n: jnp.asarray(v) for n, v in p.items()})
    tm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **FP8),
                     device="cpu")
    tm.load_state_dict(T.params_from_numpy(p, "cpu"))
    loss = scale * tm.apply(torch.from_numpy(idx), torch.from_numpy(tgt))
    names = [n for n, _ in tm.named_parameters()]
    tg = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    for name in QUANT:
        got, want = tg["h." + name].numpy(), np.asarray(jg["h." + name])
        assert np.count_nonzero(want) > 0.9 * want.size, name
        assert np.mean(got == want) >= 0.999, name
        # a flipped code is one e4m3 step: at most 1/8 of its magnitude
        np.testing.assert_allclose(got, want, rtol=0.125,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    for name in names:
        if name[2:] not in QUANT:
            np.testing.assert_allclose(tg[name].numpy(),
                                       np.asarray(jg[name]), rtol=1e-4,
                                       atol=1e-6 * scale, err_msg=name)


def test_single_device_fp8_matches_jax():
    import jax
    import jax.numpy as jnp
    import tiny_deepspeed_tpu as J
    jm, _ = _masters("init")
    jeng = J.SingleDevice(jm, J.AdamW(lr=1e-3, weight_decay=0.1))
    jstate = jeng.init(jax.random.PRNGKey(0))
    p = {n: np.asarray(v) for n, v in jstate.params.items()}
    model = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **FP8),
                        device="cpu")
    eng = T.SingleDevice(model, T.AdamW(lr=1e-3, weight_decay=0.1),
                         device="cpu")
    state = eng.load_params(eng.init(0), T.params_from_numpy(p, "cpu"))
    jl, tl = [], []
    for x, y in _batches(10):
        jstate, loss = jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))
        tl.append(float(eng.step(state, (x, y))[1]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_zero3_fp8_matches_jax_data2(tmp_path):
    """10 fp8 Zero3 steps at data 2 against JAX's (see the module
    docstring for the 2e-4); prints the measured gap (pytest -s): the
    codes of the final masters that differ from JAX's, the params' and
    the losses' largest differences."""
    res, jstate, jeng, jl, rms = check_against_jax(
        tmp_path, "Zero3", 2, 1, model_kw=FP8, atol=2e-4)
    want = _jax_stacked(jeng.model, {n: np.asarray(v)
                                     for n, v in jstate.params.items()})
    tm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **FP8),
                     device="cpu")
    got = tm.stacked_compute_params(res["params"])
    flips = sum(int((got[n].view(torch.uint8).numpy()
                     != want[n].view(np.uint8)).sum()) for n in QUANT)
    total = sum(want[n].size for n in QUANT)
    assert flips <= 0.01 * total
    dparam = max(float(np.abs(p.numpy() - np.asarray(jstate.params[n]))[
        np.broadcast_to(rms[n] >= RMS_FLOOR, p.shape)].max())
        for n, p in res["params"].items())
    dloss = float(np.max(np.abs(np.asarray(res["losses"]) - jl) / jl))
    print(f"fp8 Zero3 data 2 vs JAX after 10 steps: {flips} of {total} "
          f"codes differ; params max abs diff {dparam:.3g} (on the "
          f"elements held); losses max rel diff {dloss:.3g}")


def test_loss_curve_tracks_unquantized():
    """JAX's tests/test_fp8_gather.py::test_loss_curve_tracks_unquantized
    at its config: 30 steps on one batch under the fp8 gather stay within
    5% of the unquantized curve, and train."""
    cfg = T.GPTConfig(block_size=32, vocab_size=128, n_layer=2, n_head=2,
                      n_embd=32, compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = tuple(rng.integers(0, 128, (8, 32)) for _ in range(2))

    def run(quant):
        model = T.GPT2Model(dataclasses.replace(
            cfg, gather_quant="fp8" if quant else None), device="cpu")
        eng = T.SingleDevice(model, T.AdamW(lr=1e-3), device="cpu")
        state = eng.init(0)
        return [float(eng.step(state, batch)[1]) for _ in range(30)]

    base, quant = run(False), run(True)
    rel = [abs(a - b) / a for a, b in zip(base, quant)]
    assert max(rel) < 0.05, f"max divergence {max(rel):.3f}"
    assert quant[-1] < quant[0] - 0.3
