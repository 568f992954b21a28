# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Ring attention: causal attention over a sequence split across ranks.

Counterpart of `tiny_deepspeed_tpu/parallel/ring_attention.py::_ring_fa2`
(:130-247) and `ring_attention_local` (:250).  Each rank of the seq group
holds (B, H, Tl, Dh) queries and (B, KVH, Tl, Dh) keys and values of its
Tl positions (rank s holds positions [s*Tl, (s+1)*Tl)); the K/V chunks
rotate around the ring, at KVH heads.  The structure is JAX's, step for
step:

- forward: the diagonal chunk is peeled off and runs causal; then for
  i = 1..n-1 each rank ROTATES its K/V first (to rank + 1, from rank - 1)
  and, holding chunk (rank - i), computes it unmasked only when
  i <= rank (a chunk wholly behind its queries).  A chunk ahead of the
  queries launches nothing, but the rank still rotates.  The per-chunk
  (o, lse) pairs merge in logsumexp space in f32 (:170-176);
- backward: di = rowsum(do * o) in f32 (:197); the diagonal's dq and
  dk/dv, then the same ring with f32 dk/dv accumulators rotating beside
  K/V — the gradient accumulated FOR a chunk travels with it — and one
  last rotation brings each rank's dk/dv home (:213-240).  dq and dk/dv
  of a chunk take the GLOBAL merged lse and di.

`ring_fwd` and `ring_bwd` are plain functions over a communicator with
`rank`, `size` and `rotate(x)`; `RingAttentionFn` ties them into one
differentiable op.  The chunks run `ops/flash_fa2.py`'s chunk entries:
the CUDA kernels on CUDA tensors, their plain versions on CPU tensors
(`kernels=False` takes the plain versions on any device, for
`attn_impl="standard_attention"`).  There is no SDPA and no masked-scan
fallback.  Where JAX selects a skipped chunk's zero contribution with
`lax.cond` and merges it (o_c = 0, lse_c = -1e30), the port skips the
merge: logaddexp(lse, -1e30) = lse and the weights are 1 and 0, so the
result is the same.

Two communicators: `mesh.GroupRing` over a process group (the engines)
and `LockstepRing` over threads of one process.  `LockstepRing` is a
harness for the card check and the CPU tests — n threads, one per
virtual rank, call `ring_fwd` / `ring_bwd` directly — and no engine uses
it.  Through autograd it would deadlock: the autograd engine runs every
thread's backward on one device thread, so one thread's rotate would
wait on a barrier the others never reach.
"""

from __future__ import annotations

import threading

import torch

from ..ops import flash_fa2
from ..ops.dispatch import acc_dtype


def _chunk_ops(kernels: bool):
    """(fwd, dq, dkv) per chunk, looked up at call time."""
    if kernels:
        return (flash_fa2.fa2_chunk_fwd, flash_fa2.fa2_chunk_dq,
                flash_fa2.fa2_chunk_dkv)
    return (flash_fa2._fa2_fwd_plain, flash_fa2._fa2_dq_plain,
            flash_fa2._fa2_dkv_plain)


def ring_fwd(q, k, v, comm, kernels: bool = True):
    """Forward of one rank's shard -> (o like q, lse (B, H, Tl) f32)."""
    fwd = _chunk_ops(kernels)[0]
    acc = acc_dtype(q.dtype)  # f32 (f64 for f64 inputs)
    o, lse = fwd(q, k, v, causal=True)  # the peeled diagonal
    o_run = o.to(acc)
    kc, vc = k, v
    for i in range(1, comm.size):
        kc, vc = comm.rotate(kc), comm.rotate(vc)
        if i > comm.rank:
            continue  # chunk rank - i is ahead of every local query
        o_c, lse_c = fwd(q, kc, vc, causal=False)
        lse_new = torch.logaddexp(lse, lse_c)
        o_run = (o_run * torch.exp(lse - lse_new)[..., None]
                 + o_c.to(acc) * torch.exp(lse_c - lse_new)[..., None])
        lse = lse_new
    return o_run.to(q.dtype), lse


def ring_bwd(saved, do, comm, kernels: bool = True):
    """Backward of one rank's shard from `saved` = (q, k, v, o, lse) ->
    (dq, dk, dv) like (q, k, v)."""
    _, dq_fn, dkv_fn = _chunk_ops(kernels)
    q, k, v, o, lse = saved
    acc = acc_dtype(q.dtype)
    do = do.contiguous()
    di = (do.to(acc) * o.to(acc)).sum(dim=-1)
    dq_run = dq_fn(q, k, v, do, lse, di, causal=True).to(acc)
    dk, dv = dkv_fn(q, k, v, do, lse, di, causal=True)
    dka, dva = dk.to(acc), dv.to(acc)
    kc, vc = k, v
    for i in range(1, comm.size):
        kc, vc = comm.rotate(kc), comm.rotate(vc)
        dka, dva = comm.rotate(dka), comm.rotate(dva)
        if i > comm.rank:
            continue
        dq_run = dq_run + dq_fn(q, kc, vc, do, lse, di, causal=False).to(acc)
        dk_c, dv_c = dkv_fn(q, kc, vc, do, lse, di, causal=False)
        dka, dva = dka + dk_c.to(acc), dva + dv_c.to(acc)
    if comm.size > 1:  # one rotation short of home: finish the cycle
        dka, dva = comm.rotate(dka), comm.rotate(dva)
    return dq_run.to(q.dtype), dka.to(k.dtype), dva.to(v.dtype)


class RingAttentionFn(torch.autograd.Function):
    """Ring attention as one differentiable op (JAX `_ring_fa2`'s
    custom_vjp): the forward saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, comm, kernels=True):
        o, lse = ring_fwd(q, k, v, comm, kernels)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.comm, ctx.kernels = comm, kernels
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = ring_bwd(ctx.saved_tensors, do, ctx.comm, ctx.kernels)
        return dq, dk, dv, None, None


def ring_attention(q, k, v, comm, kernels: bool = True):
    """Causal attention of this rank's (B, H, Tl, Dh) shard over the
    whole sequence held by `comm`'s ranks (JAX `ring_attention_local`)."""
    return RingAttentionFn.apply(q, k, v, comm, kernels)


class LockstepRing:
    """n threads of one process as a ring (a test and card harness; no
    engine uses it).  `comm(rank)` is rank's communicator; its rotate
    puts x in rank's slot, waits for every rank, reads slot rank - 1 and
    waits again before the slots are reused.  The tensors are passed by
    reference: on one card the threads share its default stream, so a
    kernel reading a rotated tensor runs after the one that wrote it."""

    def __init__(self, n: int):
        self.size = n
        self._slots = [None] * n
        self._barrier = threading.Barrier(n)

    def comm(self, rank: int) -> "_LockstepComm":
        return _LockstepComm(self, rank)


class _LockstepComm:
    def __init__(self, ring: LockstepRing, rank: int):
        self.ring, self.rank, self.size = ring, rank, ring.size

    def rotate(self, x):
        r = self.ring
        r._slots[self.rank] = x
        r._barrier.wait()
        out = r._slots[(self.rank - 1) % self.size]
        r._barrier.wait()
        return out


def run_lockstep(n: int, fn, hub=None):
    """Run fn(rank, comm) on n threads of `hub` (default a `LockstepRing`;
    any lockstep hub with `comm(rank)` and a `_barrier`); returns the
    results in rank order and re-raises the first failure (after
    aborting the barrier, so no thread waits forever)."""
    ring = LockstepRing(n) if hub is None else hub
    out, errors = [None] * n, []

    def work(rank):
        try:
            out[rank] = fn(rank, ring.comm(rank))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            ring._barrier.abort()

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
