# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Ulysses sequence parallelism in the PyTorch port against the JAX
package, on the CPU, in f32.

Pinned here:

- `ops.attention.sharded_attention` under a Ulysses context over n
  lockstep threads (n = 2 and 4; MHA, K/V grouped at kv_heads when n
  divides them, expanded when not) against JAX's `sharded_attention` on
  a (data 1, seq n) CPU mesh: o, dq, dk, dv within 1e-5, and the heads
  each all-to-all moved;
- the card harness `ulysses_fwd` / `ulysses_bwd` bit for bit the
  autograd route, and both equal to whole-sequence attention;
- DDP and Zero2 at data 2 x seq 2 (one 4-rank gloo spawn, run by
  tests/test_torch_ulysses_dist.py), and Zero3 gpt2-tiny, Zero2
  llama-tiny (grouped K/V, JAX's `TestGQAUlysses`) and DDP moe-tiny at
  seq 2 (one 2-rank spawn, which also runs
  `ulysses_attention` over the `GroupAllToAll`), each under Ulysses
  against the JAX engine with `seq_impl="ulysses"`, 10 steps: losses
  1e-4, params and optimizer state 1e-5 (tests/test_torch_dist.py's
  rule);
- JAX's refusal of a head count the seq size does not divide, word for
  word; the schedule's slots refuse a seq split under Ulysses as under
  the ring (the executors run without one, so they never meet either).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.ops import attention as att
from tiny_deepspeed_tpu_torch.ops import flash_fa2 as fa
from tiny_deepspeed_tpu_torch.parallel import ulysses as U
from tiny_deepspeed_tpu_torch.parallel.mesh import ParallelContext
from test_torch_dist import _jax_run, compare_with_jax, multi_engine_worker
from test_torch_ring import spawn

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkvd(b=2, h=4, kvh=4, t=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, t, d), dtype=np.float32),
            rng.standard_normal((b, kvh, t, d), dtype=np.float32),
            rng.standard_normal((b, kvh, t, d), dtype=np.float32),
            rng.standard_normal((b, h, t, d), dtype=np.float32))


def _chunk(a, r, n):
    tl = a.shape[2] // n
    return a[:, :, r * tl:(r + 1) * tl]


class _Recording:
    """A communicator that records the head count of every tensor it
    moves (x is (n, B, heads, Tl, Dh))."""

    def __init__(self, comm, log):
        self.comm, self.log = comm, log
        self.rank, self.size = comm.rank, comm.size

    def all_to_all(self, x):
        self.log.append(x.shape[0] * x.shape[2])
        return self.comm.all_to_all(x)


def _thread_ulysses(q, k, v, do, n, impl="flash_attention"):
    """sharded_attention under a Ulysses context on n lockstep threads,
    through autograd -> (whole-sequence o, dq, dk, dv as numpy, the head
    counts rank 0's all-to-alls moved)."""
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    log = []

    def rank(r, comm):
        pctx = ParallelContext(
            world=n, rank=r, data_size=1, seq_size=n, data_rank=0,
            seq_rank=r, seq_impl="ulysses",
            seq_comm=_Recording(comm, log if r == 0 else []))
        args = [_chunk(a, r, n).clone().requires_grad_()
                for a in (tq, tk, tv)]
        o = att.sharded_attention(*args, impl, pctx)
        o.backward(_chunk(tdo, r, n))
        return [o.detach()] + [a.grad for a in args]

    out = U.run_lockstep(n, rank)
    return [torch.cat([o[i] for o in out], dim=2).numpy()
            for i in range(4)], log


@pytest.mark.parametrize("n,kvh,moved", [
    (2, 4, [4, 4, 4, 4, 4, 4, 4, 4]),
    (4, 4, [4, 4, 4, 4, 4, 4, 4, 4]),
    (2, 2, [4, 2, 2, 4, 4, 2, 2, 4]),   # grouped: K/V at kv_heads
    (4, 2, [4, 4, 4, 4, 4, 4, 4, 4]),   # 4 does not divide 2: expanded
], ids=["n2-mha", "n4-mha", "n2-grouped", "n4-expanded"])
def test_ulysses_matches_jax(n, kvh, moved):
    """Against JAX's `sharded_attention` with seq_impl="ulysses" (its
    `gqa_ulysses` choice included) — forward and vjp.  The all-to-alls:
    q, k, v to heads, o home; then the backward's do to heads and dq,
    dk, dv home."""
    import jax
    import jax.numpy as jnp
    from tiny_deepspeed_tpu import make_mesh
    from tiny_deepspeed_tpu.ops.attention import sharded_attention
    from tiny_deepspeed_tpu.parallel.mesh import ParallelContext as JP
    q, k, v, do = _qkvd(kvh=kvh, seed=10 * n + kvh)
    mesh = make_mesh((1, n), ("data", "seq"), devices=jax.devices()[:n])
    jp = JP(mesh=mesh, seq_axis="seq", seq_impl="ulysses")

    def both(q, k, v, do):
        o, vjp = jax.vjp(
            lambda *a: sharded_attention(*a, "flash_attention", jp), q, k, v)
        return (o, *vjp(do))

    want = jax.jit(both)(*map(jnp.asarray, (q, k, v, do)))
    got, log = _thread_ulysses(q, k, v, do, n)
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)
    # forward q, k, v, o in order; the backward's order is autograd's
    assert log[:4] == moved[:4]
    assert sorted(log[4:]) == sorted(moved[4:])


def test_harness_equals_autograd_and_whole_sequence():
    """`ulysses_fwd` / `ulysses_bwd` (the card's lockstep harness) give
    the autograd route's bits; both equal whole-sequence causal
    attention; "standard_attention" expands grouped K/V (JAX's
    `_expand`) and computes the same."""
    q, k, v, do = _qkvd(kvh=2, seed=3)
    n = 2
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))

    def rank(r, comm):
        args = [_chunk(a, r, n) for a in (tq, tk, tv)]
        o, saved = U.ulysses_fwd(*args, comm, att.flash_attention)
        return [o, *U.ulysses_bwd(saved, _chunk(tdo, r, n), comm)]

    out = U.run_lockstep(n, rank)
    harness = [torch.cat([o[i] for o in out], dim=2).numpy()
               for i in range(4)]
    auto, _ = _thread_ulysses(q, k, v, do, n)
    for a, b in zip(harness, auto):
        np.testing.assert_array_equal(a, b)
    std, log = _thread_ulysses(q, k, v, do, n, "standard_attention")
    assert log == [4] * 8
    o, lse = fa._fa2_fwd_plain(tq, tk, tv)
    di = (tdo * o).sum(-1)
    want = (o, fa._fa2_dq_plain(tq, tk, tv, tdo, lse, di),
            *fa._fa2_dkv_plain(tq, tk, tv, tdo, lse, di))
    for g, s, w in zip(harness, std, want):
        np.testing.assert_allclose(g, w.numpy(), **TOL)
        np.testing.assert_allclose(s, w.numpy(), **TOL)


def _a2a_hook(rank, out_dir, tag):
    """Before the first configuration: `ulysses_attention` over the
    process group's `GroupAllToAll` through its autograd Functions."""
    from tiny_deepspeed_tpu_torch.parallel import mesh
    pctx = mesh.make_context(seq_parallel=2, seq_impl="ulysses")
    assert isinstance(pctx.seq_comm, mesh.GroupAllToAll)
    q, k, v, do = (torch.from_numpy(a) for a in _qkvd(kvh=2, seed=30))
    args = [_chunk(a, rank, 2).clone().requires_grad_() for a in (q, k, v)]
    o = U.ulysses_attention(*args, pctx.seq_comm, att.flash_attention)
    o.backward(_chunk(do, rank, 2))
    torch.save([o.detach()] + [a.grad for a in args],
               os.path.join(out_dir, f"a2a_{rank}.pt"))


_ULY = dict(seq_impl="ulysses")
_SPAWNS = {
    "data2_seq2": (4, [
        dict(name="DDP", dp=2, sp=2),
        dict(name="Zero2", dp=2, sp=2)]),
    "seq2": (2, [
        dict(name="Zero3", dp=1, sp=2, hook=(_a2a_hook, ())),
        # the random tokens sit near ln(vocab): JAX's loss does not fall
        dict(name="Zero2", dp=1, sp=2, preset="llama-tiny", progress=False),
        dict(name="DDP", dp=1, sp=2, preset="moe-tiny")]),
}


@pytest.mark.parametrize("spawn_id", ["seq2"])
def test_engines_under_ulysses_match_jax(tmp_path, spawn_id):
    """(data2_seq2: tests/test_torch_ulysses_dist.py)"""
    check_spawn(tmp_path, spawn_id)


def check_spawn(tmp_path, spawn_id):
    """Each configuration of one gloo spawn against the JAX engine of its
    layout with seq_impl="ulysses"."""
    world, configs = _SPAWNS[spawn_id]
    runs, outs = [], []
    for i, c in enumerate(configs):
        preset = c.get("preset", "tiny")
        out = _jax_run(c["name"], c["dp"], c["sp"], _ULY, "adamw", 1, False,
                       None, preset)
        np.savez(tmp_path / f"params{i}.npz", **out[0])
        outs.append(out)
        runs.append(dict(name=c["name"], sp=c["sp"], kw=_ULY, opt="adamw",
                         accum=1, overflow=False, preset=preset,
                         tag=str(i), hook=c.get("hook")))
    spawn(multi_engine_worker, world, tmp_path, runs, timeout=240)
    for i, c in enumerate(configs):
        res = torch.load(tmp_path / f"result{i}.pt")
        assert res["lowering"] == "plain"
        compare_with_jax(res, outs[i], c["dp"],
                         progress=c.get("progress", True))
    if spawn_id == "seq2":
        got = [torch.load(tmp_path / f"a2a_{r}.pt") for r in range(2)]
        got = [torch.cat([g[i] for g in got], dim=2).numpy()
               for i in range(4)]
        want, _ = _thread_ulysses(*_qkvd(kvh=2, seed=30), 2)
        for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=name)


def _pctx(seq, impl="ulysses"):
    """A seq-split context no collective is ever run on."""
    return ParallelContext(world=seq, rank=0, data_size=1, seq_size=seq,
                           data_rank=0, seq_rank=0, seq_impl=impl)


def test_indivisible_heads_refused_with_jax_message():
    import jax
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models import build_model as jbuild
    from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
    mesh = J.make_mesh((1, 3), ("data", "seq"), devices=jax.devices()[:3])
    with pytest.raises(ValueError) as want:
        J.DDP(jbuild(JP["tiny"]), J.AdamW(), mesh=mesh, seq_impl="ulysses")
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    for cls in (T.DDP, T.Zero1, T.Zero2, T.Zero3):
        with pytest.raises(ValueError) as got:
            cls(pm, T.AdamW(), device="cpu", pctx=_pctx(3))
        assert str(got.value) == str(want.value)
    # the ring takes any head count; a divisible one builds under Ulysses
    T.DDP(pm, T.AdamW(), device="cpu", pctx=_pctx(3, "ring"))
    T.DDP(pm, T.AdamW(), device="cpu", pctx=_pctx(2))
    with pytest.raises(ValueError, match="seq_impl must be 'ring' or "
                                         "'ulysses', got 'star'"):
        T.parallel.make_context(1, "star")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_schedule_slots_refuse_a_seq_split_under_either_impl(impl):
    """The schedule's executors and bucketed releases run the layers
    without a seq split: their slots refuse one (JAX's message) under
    Ulysses exactly as under the ring, so the attention route they meet
    is the unsplit one either way."""
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    pctx = ParallelContext(world=4, rank=0, data_size=2, seq_size=2,
                           data_rank=0, seq_rank=0, seq_impl=impl)
    with pytest.raises(ValueError, match="the grad slot needs a pure "
                                         "data-parallel mesh"):
        T.Zero2(pm, T.AdamW(), device="cpu", pctx=pctx, grad_buckets=2)
    drop = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                           dropout=0.1), device="cpu")
    with pytest.raises(ValueError, match="the grad slot needs a pure"):
        T.DDP(drop, T.AdamW(), device="cpu", pctx=pctx, grad_comm="int8")
