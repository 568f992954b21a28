# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Ring attention in the PyTorch port against the JAX package, on the CPU.

Pinned here, in f32 at 1e-5:

- the FA2 chunk entries' plain versions (`fa2_chunk_fwd`, `_dq`, `_dkv`,
  causal and unmasked, MHA and grouped K/V) against the JAX chunk entries
  run as Pallas kernels in interpret mode;
- the port's ring over four lockstep threads (o and dq/dk/dv) against
  JAX `ring_attention` on a 4-device ("seq",) CPU mesh — its masked jnp
  ring — and against JAX's kernel ring `_ring_fa2` in interpret mode,
  MHA and GQA;
- the same ring over four spawned gloo processes, through the autograd
  Function, equal to the thread version.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import os

import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu_torch.ops import flash_fa2 as fa
from tiny_deepspeed_tpu_torch.parallel import ring_attention as ra

TOL = dict(rtol=1e-5, atol=1e-5)
N_RING = 4


def _qkvd(b=2, h=4, kvh=4, t=64, d=32, seed=0):
    """Seeded f32 q, k, v, do as numpy: (B, H, T, D) and (B, KVH, T, D)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, t, d), dtype=np.float32),
            rng.standard_normal((b, kvh, t, d), dtype=np.float32),
            rng.standard_normal((b, kvh, t, d), dtype=np.float32),
            rng.standard_normal((b, h, t, d), dtype=np.float32))


@pytest.fixture
def jax_fa2_interpret(monkeypatch):
    """The JAX package's FA2 Pallas kernels in interpret mode, the kernel
    gate forced to the TPU target (as tests/test_ring_attention.py)."""
    from tiny_deepspeed_tpu.ops import flash_fa2 as jfa
    from tiny_deepspeed_tpu.ops.dispatch import kernel_target_forced
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    with kernel_target_forced("tpu"):
        yield jfa


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "unmasked"])
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa2"])
def test_chunk_entries_match_jax(jax_fa2_interpret, causal, kvh):
    import jax.numpy as jnp
    jfa = jax_fa2_interpret
    q, k, v, do = _qkvd(kvh=kvh, seed=1 + kvh)
    b, h, t, d = q.shape
    group = h // kvh
    flat = lambda a: jnp.asarray(a.reshape(-1, t, d))  # noqa: E731
    jo, jlse = jfa.fa2_chunk_fwd(flat(q), flat(k), flat(v), causal=causal,
                                 group=group)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.fa2_chunk_fwd(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(o.numpy().reshape(-1, t, d), jo, **TOL)
    np.testing.assert_allclose(lse.numpy().reshape(-1, 1, t), jlse, **TOL)
    # the backward from a GLOBAL lse (this chunk merged with another's)
    # and di, as the ring gives them
    lse_g = torch.logaddexp(lse, lse - 0.5)
    di = (tdo * o).sum(-1)
    jst = lambda a: jnp.asarray(a.numpy().reshape(-1, 1, t))  # noqa: E731
    jargs = (flat(q), flat(k), flat(v), flat(do), jst(lse_g), jst(di))
    jdq = jfa.fa2_chunk_dq(*jargs, causal=causal, group=group)
    jdk, jdv = jfa.fa2_chunk_dkv(*jargs, causal=causal, group=group)
    dq = fa.fa2_chunk_dq(tq, tk, tv, tdo, lse_g, di, causal=causal)
    dk, dv = fa.fa2_chunk_dkv(tq, tk, tv, tdo, lse_g, di, causal=causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy().reshape(-1, t, d), want,
                                   **TOL)


def _chunk(a, r, n=N_RING):
    tl = a.shape[2] // n
    return a[:, :, r * tl:(r + 1) * tl]


def _thread_ring(q, k, v, do, kernels=True):
    """The port's ring on N_RING lockstep threads -> whole-sequence (o,
    dq, dk, dv) as numpy."""
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))

    def rank(r, comm):
        args = [_chunk(a, r) for a in (tq, tk, tv)]
        o, lse = ra.ring_fwd(*args, comm, kernels)
        return (o, *ra.ring_bwd((*args, o, lse), _chunk(tdo, r), comm,
                                kernels))

    out = ra.run_lockstep(N_RING, rank)
    return [torch.cat([o[i] for o in out], dim=2).numpy() for i in range(4)]


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa2"])
def test_thread_ring_matches_jax_ring(kvh):
    """Against JAX `ring_attention` on a 4-device seq mesh (the jnp ring:
    masked full chunks, no skip) — forward and vjp."""
    import jax
    import jax.numpy as jnp
    from tiny_deepspeed_tpu import make_mesh
    from tiny_deepspeed_tpu.parallel.ring_attention import ring_attention
    q, k, v, do = _qkvd(kvh=kvh, t=64, seed=10 + kvh)
    mesh = make_mesh(axis_names=("seq",), devices=jax.devices()[:N_RING])
    jo, vjp = jax.vjp(lambda *a: ring_attention(*a, mesh), *map(
        jnp.asarray, (q, k, v)))
    want = (jo, *vjp(jnp.asarray(do)))
    got = _thread_ring(q, k, v, do)
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa2"])
def test_thread_ring_matches_jax_kernel_ring(jax_fa2_interpret, kvh):
    """Against JAX's kernel ring `_ring_fa2` (Pallas chunk kernels in
    interpret mode, the same peeled-diagonal and skip structure)."""
    import jax
    import jax.numpy as jnp
    from tiny_deepspeed_tpu import make_mesh
    from tiny_deepspeed_tpu.parallel.ring_attention import ring_attention
    q, k, v, do = _qkvd(kvh=kvh, t=64, seed=20 + kvh)
    mesh = make_mesh(axis_names=("seq",), devices=jax.devices()[:N_RING])
    jo, vjp = jax.vjp(lambda *a: ring_attention(*a, mesh), *map(
        jnp.asarray, (q, k, v)))
    want = (jo, *vjp(jnp.asarray(do)))
    got = _thread_ring(q, k, v, do)
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TOL)


def test_thread_ring_plain_and_full_attention():
    """kernels=False (the standard_attention ring) computes the same, and
    the ring equals whole-sequence causal attention."""
    q, k, v, do = _qkvd(kvh=2, t=64, seed=5)
    got = _thread_ring(q, k, v, do)
    plain = _thread_ring(q, k, v, do, kernels=False)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa._fa2_fwd_plain(tq, tk, tv)
    di = (tdo * o).sum(-1)
    want = (o, fa._fa2_dq_plain(tq, tk, tv, tdo, lse, di),
            *fa._fa2_dkv_plain(tq, tk, tv, tdo, lse, di))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), **TOL)


def _ring_worker(rank, world, store, out_dir, kvh):
    """One gloo rank: the ring through its autograd Function."""
    import torch.distributed as dist

    from tiny_deepspeed_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        pctx = mesh.make_context(seq_parallel=world)
        q, k, v, do = (torch.from_numpy(a) for a in _qkvd(kvh=kvh, seed=30))
        args = [_chunk(a, rank).clone().requires_grad_() for a in (q, k, v)]
        o = ra.ring_attention(*args, pctx.seq_comm)
        o.backward(_chunk(do, rank))
        torch.save([o.detach()] + [a.grad for a in args],
                   os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(worker, world, tmp_path, *args, timeout=120):
    """Run worker(rank, world, store, out_dir, *args) on `world` spawned
    processes over a file:// store; fail (killing the rest) on a non-zero
    exit or when `timeout` seconds pass — a hung collective fails the
    test, not the suite."""
    import time

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=worker,
                         args=(r, world, store, str(tmp_path), *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
        # a rank that died leaves the others blocked in a collective: the
        # exit codes say which happened first
        assert not hung, (f"ranks {hung} still running after {timeout}s "
                          f"(exit codes {codes})")
        assert codes == [0] * world, f"exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa2"])
def test_process_ring_equals_thread_ring(tmp_path, kvh):
    spawn(_ring_worker, N_RING, tmp_path, kvh)
    got = [torch.load(tmp_path / f"{r}.pt") for r in range(N_RING)]
    got = [torch.cat([g[i] for g in got], dim=2).numpy() for i in range(4)]
    q, k, v, do = _qkvd(kvh=kvh, seed=30)
    for g, w, name in zip(got, _thread_ring(q, k, v, do),
                          ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
