# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's distributed engines on `MoEGPT` against the JAX package's,
on the CPU over gloo.

The f32 MoE config of tests/test_torch_moe.py (2 layers, 4 heads, n_embd
32, 4 experts, top-2) is initialised by the JAX engine from a seed and
its weights cross to the port through numpy.  The port's engines run on
spawned gloo processes — one spawn of 2 ranks runs every data-2 case in
turn, one of 4 ranks the data 2 x seq 2 case — every rank stepping on
the same global batches of 4 rows; the JAX engines run on a CPU mesh of
2 devices.  Pinned here, over 10 AdamW steps:

- DDP and Zero2 at data 2 with the einsum dispatch, routed over the
  global panel as JAX's GSPMD routes it (capacity from the global token
  count, slots in global token order, the load-balancing fractions over
  every rank's tokens), against JAX's DDP;
- the same with `capacity_factor` 0.5, where the global slot order
  decides which tokens drop (rank-local routing drops others);
- DDP and Zero2 at data 2 with the sort dispatch, shard-local (capacity
  from the rank's tokens, the term averaged over ranks), against JAX's
  DDP (its `shard_map` + `pmean`);
- Zero2 at data 2 x seq 2 with the sort dispatch configured: it falls
  back to the einsum path, whose routing a sequence split leaves
  unchanged, so JAX's data-2 einsum run is the reference;
- Zero3 with the fp8 gather at data 2 against JAX's fp8 Zero3;

loss trajectories within 1e-4 relative of JAX's (the fp8 gather: 2e-4,
as tests/test_torch_fp8_gather.py holds fp8 ZeRO-3), and the gathered
params within 1e-3 (Adam's normalized step turns roundoff of near-zero
gradients into up to a step of lr = 1e-3).  At world 1 every engine, for
both dispatches and with the fp8 gather, is bit for bit SingleDevice.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import moe as TM
from test_torch_dist import world1  # noqa: F401
from test_torch_ring import spawn

B, SEQ, STEPS, LR = 4, 32, 10, 1e-3
_CFG = dict(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=32,
            n_expert=4, expert_top_k=2)
OVERFLOW = dict(capacity_factor=0.5)
# case -> (port engine, config overrides, JAX reference run)
DATA2 = {
    "ddp-einsum": ("DDP", {}, "einsum"),
    "zero2-einsum": ("Zero2", {}, "einsum"),
    "ddp-einsum-overflow": ("DDP", OVERFLOW, "einsum-overflow"),
    "ddp-sort": ("DDP", dict(moe_dispatch="sort"), "sort"),
    "zero2-sort": ("Zero2", dict(moe_dispatch="sort"), "sort"),
    "zero3-fp8": ("Zero3", dict(gather_quant="fp8"), "zero3-fp8"),
}
# JAX reference run -> (JAX engine, config overrides)
JAX_RUNS = {"einsum": ("DDP", {}),
            "einsum-overflow": ("DDP", OVERFLOW),
            "sort": ("DDP", dict(moe_dispatch="sort")),
            "zero3-fp8": ("Zero3", dict(gather_quant="fp8"))}


def _batches(n):
    loader = T.TokenLoader(None, B, SEQ, vocab_size=128, seed=3)
    return [loader.next() for _ in range(n)]


def _worker(rank, world, store, out_dir, cases, sp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        ref = T.params_from_numpy(
            dict(np.load(os.path.join(out_dir, "params.npz"))), "cpu")
        out = {}
        for case, (name, over) in cases.items():
            model = T.MoEGPT(TM.MoEConfig(compute_dtype=torch.float32,
                                          **_CFG, **over), device="cpu")
            engine = getattr(T, name)(model,
                                      T.AdamW(lr=LR, weight_decay=0.1),
                                      device="cpu", seq_parallel=sp)
            state = engine.init(0)
            engine.load_params(state, ref)
            losses = []
            for batch in _batches(STEPS):
                state, loss = engine.step(state, batch)
                losses.append(float(loss))
            out[case] = {"losses": losses,
                         "params": engine.gather_params(state),
                         "rank_map": engine.rank_map}
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """JAX's initial params (saved for the workers) and its loss and
    param trajectories of each reference run at data 2."""
    import jax
    import jax.numpy as jnp
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models import moe as JM
    out_dir = tmp_path_factory.mktemp("moe_dist")
    mesh = J.make_mesh((2,), ("data",), devices=jax.devices()[:2])
    runs = {}
    for key, (name, over) in JAX_RUNS.items():
        jeng = getattr(J, name)(
            JM.MoEGPT(JM.MoEConfig(compute_dtype=jnp.float32, **_CFG,
                                   **over)),
            J.AdamW(lr=LR, weight_decay=0.1), mesh=mesh)
        state = jeng.init(jax.random.PRNGKey(0))
        if not runs:
            np.savez(out_dir / "params.npz",
                     **{n: np.asarray(p) for n, p in state.params.items()})
        losses = []
        for x, y in _batches(STEPS):
            state, loss = jeng.step(state, (jnp.asarray(x), jnp.asarray(y)))
            losses.append(float(loss))
        runs[key] = {"losses": losses, "rank_map": jeng.rank_map,
                     "params": {n: np.asarray(p)
                                for n, p in state.params.items()}}
    return out_dir, runs


@pytest.fixture(scope="module")
def data2(jax_ref):
    """Every data-2 case, run in turn by one spawn of 2 gloo ranks."""
    out_dir, _ = jax_ref
    spawn(_worker, 2, out_dir,
          {case: (name, over) for case, (name, over, _) in DATA2.items()},
          1, timeout=240)
    return torch.load(out_dir / "result.pt")


def _check(res, ref, rtol):
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=rtol)
    assert res["rank_map"] == ref["rank_map"]
    for n, p in res["params"].items():
        np.testing.assert_allclose(p.numpy(), ref["params"][n], atol=1e-3,
                                   err_msg=n)


@pytest.mark.parametrize("case", list(DATA2))
def test_data2_matches_jax(jax_ref, data2, case):
    ref = jax_ref[1][DATA2[case][2]]
    _check(data2[case], ref, 2e-4 if case == "zero3-fp8" else 1e-4)


def test_overflow_is_routed_globally(jax_ref):
    """The overflow case tells global routing from rank-local: JAX's
    routing of the whole 4-row panel keeps other (token, expert) pairs
    than each 2-row half routed alone (capacity from its own tokens,
    slots in its own order), and on the first batch the two halves'
    gradients averaged (what rank-local routing would hand the engine)
    put the experts' gradients off the whole panel's by over 10% of
    their scale — the params the data-2 case holds within 1e-3 would
    part at once."""
    import jax
    import jax.numpy as jnp
    from tiny_deepspeed_tpu.models import moe as JM
    out_dir, runs = jax_ref
    jm = JM.MoEGPT(JM.MoEConfig(compute_dtype=jnp.float32, **_CFG,
                                **OVERFLOW))
    rng = np.random.default_rng(9)
    xs = jnp.asarray(rng.standard_normal((B * SEQ, 32)), jnp.float32)
    w = jnp.asarray(0.5 * rng.standard_normal((32, 4)), jnp.float32)

    def kept(d, off):
        cap = d.shape[2]
        return {(int(s) + off, int(ec) // cap) for s, ec in
                zip(*np.nonzero(np.asarray(d).reshape(d.shape[0], -1)))}

    half = B * SEQ // 2
    assert kept(jm._route(xs, w)[0], 0) != (
        kept(jm._route(xs[:half], w)[0], 0)
        | kept(jm._route(xs[half:], w)[0], half))
    params = {n: jnp.asarray(v)
              for n, v in np.load(out_dir / "params.npz").items()}
    x, y = (jnp.asarray(a) for a in _batches(1)[0])

    def grads(rows):
        return jax.value_and_grad(lambda p: jm.apply(p, x[rows], y[rows]))(
            params)

    loss, whole = grads(slice(None))
    np.testing.assert_allclose(float(loss),
                               runs["einsum-overflow"]["losses"][0],
                               rtol=1e-6)
    halves = [grads(slice(i, i + 2))[1] for i in (0, 2)]
    for n in ("h.moe.fc.w", "h.moe.proj.w"):
        want = np.asarray(whole[n])
        local = (np.asarray(halves[0][n]) + np.asarray(halves[1][n])) / 2
        assert np.abs(local - want).max() > 0.1 * np.abs(want).max(), n


def test_zero2_data2_seq2_sort_falls_back_to_einsum(tmp_path, jax_ref):
    out_dir, runs = jax_ref
    os.link(out_dir / "params.npz", tmp_path / "params.npz")
    spawn(_worker, 4, tmp_path,
          {"zero2-d2s2": ("Zero2", dict(moe_dispatch="sort"))}, 2,
          timeout=240)
    _check(torch.load(tmp_path / "result.pt")["zero2-d2s2"], runs["einsum"],
           1e-4)


@pytest.mark.parametrize("name,over", [
    ("DDP", {}), ("DDP", dict(moe_dispatch="sort")),
    ("Zero1", {}), ("Zero2", dict(moe_dispatch="sort")),
    ("Zero3", {}), ("Zero3", dict(moe_dispatch="sort")),
    ("Zero3", dict(gather_quant="fp8"))],
    ids=["ddp-einsum", "ddp-sort", "zero1-einsum", "zero2-sort",
         "zero3-einsum", "zero3-sort", "zero3-fp8"])
def test_world1_engine_equals_single_device(world1, name, over):
    """At world 1 every collective is a copy and the routing is one
    device's: losses and params bit for bit SingleDevice's over 3
    steps."""
    cfg = TM.MoEConfig(compute_dtype=torch.float32, **_CFG, **over)
    out = []
    for cls in (T.SingleDevice, getattr(T, name)):
        engine = cls(T.MoEGPT(cfg, device="cpu"),
                     T.AdamW(lr=LR, weight_decay=0.1), device="cpu")
        state = engine.init(0)
        losses = [float(engine.step(state, b)[1]) for b in _batches(3)]
        out.append((losses, engine.gather_params(state)))
    assert out[1][0] == out[0][0]
    for n, p in out[0][1].items():
        assert torch.equal(out[1][1][n], p), n
