# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Ulysses sequence parallelism: an all-to-all head / sequence reshard.

Counterpart of `tiny_deepspeed_tpu/parallel/ulysses.py`
(`ulysses_attention_local`, :33-51).  Each rank of the seq group holds
(B, H, Tl, Dh) queries and (B, KVH, Tl, Dh) keys and values of its Tl
positions (rank s holds positions [s*Tl, (s+1)*Tl)).  `to_heads` trades
the rank's Tl positions of every head for the whole sequence of H/n
heads — an all-to-all that splits H and concatenates T, giving (B, H/n,
T, Dh) with head block s on rank s — the causal `attn_fn` runs on whole
sequences (on the card the FA2 kernels #4-#6, unchanged), and `to_seq`,
the inverse all-to-all, brings the output home.  Two collectives a
direction and the single-device kernel; the ring (ring_attention.py)
instead rotates K/V chunks n - 1 times through the chunk kernels.
Needs H % n == 0 (the engine checks, with JAX's message) and, for K/V at
KVH heads, KVH % n == 0: splitting H and KVH into the same n contiguous
blocks keeps each query head's K/V head on its rank
(`ops.attention.sharded_attention` expands K/V otherwise, as JAX does).

Each all-to-all is one autograd Function whose backward is the other
all-to-all (`ulysses_attention`, what the engines run).  A communicator
has `rank`, `size` and `all_to_all(x)`: x (n, ...) holds slice j for
rank j, and the result's slice j came from rank j.
`mesh.GroupAllToAll` is one over a process group; `LockstepAllToAll`
runs n threads of one process as n ranks — a harness for the card check
and the CPU tests, which no engine uses.  On the card it goes through
`ulysses_fwd` / `ulysses_bwd`, the same computation with the local
attention differentiated on its own thread: through autograd the
collectives would deadlock, since the autograd engine runs every
thread's CUDA backward on one device thread (see ring_attention.py).
"""

from __future__ import annotations

import threading

import torch

from . import ring_attention


def to_heads(x, comm):
    """(B, H, Tl, Dh) -> (B, H/n, n*Tl, Dh): this rank's head block over
    the whole sequence."""
    n = comm.size
    b, h, t, d = x.shape
    got = comm.all_to_all(x.reshape(b, n, h // n, t, d).movedim(1, 0))
    return got.movedim(0, 2).reshape(b, h // n, n * t, d)


def to_seq(x, comm):
    """(B, H/n, T, Dh) -> (B, H, T/n, Dh): the inverse of `to_heads`."""
    n = comm.size
    b, hn, t, d = x.shape
    got = comm.all_to_all(x.reshape(b, hn, n, t // n, d).movedim(2, 0))
    return got.movedim(0, 1).reshape(b, n * hn, t // n, d)


class _ToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return to_heads(x, comm)

    @staticmethod
    def backward(ctx, g):
        return to_seq(g, ctx.comm), None


class _ToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return to_seq(x, comm)

    @staticmethod
    def backward(ctx, g):
        return to_heads(g, ctx.comm), None


def _check(q, k, comm):
    n = comm.size
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"Ulysses over {n} ranks needs the heads "
                         f"({q.shape[1]} q, {k.shape[1]} k/v) divisible "
                         f"by {n}")


def ulysses_attention(q, k, v, comm, attn_fn):
    """Causal attention of this rank's (B, H, Tl, Dh) q and (B, KVH, Tl,
    Dh) k/v shards over the whole sequence held by `comm`'s ranks:
    to_heads, `attn_fn` on whole sequences, to_seq — differentiable."""
    _check(q, k, comm)
    heads = [_ToHeads.apply(z, comm) for z in (q, k, v)]
    return _ToSeq.apply(attn_fn(*heads), comm)


def ulysses_fwd(q, k, v, comm, attn_fn):
    """`ulysses_attention`'s forward with the local attention's graph
    kept apart: (o, saved) for `ulysses_bwd`."""
    _check(q, k, comm)
    heads = [to_heads(z, comm).detach().requires_grad_() for z in (q, k, v)]
    with torch.enable_grad():
        oh = attn_fn(*heads)
    return to_seq(oh.detach(), comm), (heads, oh)


def ulysses_bwd(saved, do, comm):
    """(dq, dk, dv) like (q, k, v) from `ulysses_fwd`'s saved state and
    the output's gradient do."""
    heads, oh = saved
    grads = torch.autograd.grad(oh, heads, to_heads(do, comm))
    return tuple(to_seq(g, comm) for g in grads)


class LockstepAllToAll:
    """n threads of one process as an all-to-all group (a test and card
    harness; no engine uses it).  `comm(rank)` is rank's communicator;
    its all_to_all puts x in rank's slot, waits for every rank, stacks
    slice `rank` of every slot and waits again before the slots are
    reused.  On one card the threads share its default stream, so the
    stack runs after the kernels that wrote the slots."""

    def __init__(self, n: int):
        self.size = n
        self._slots = [None] * n
        self._barrier = threading.Barrier(n)

    def comm(self, rank: int) -> "_LockstepComm":
        return _LockstepComm(self, rank)


class _LockstepComm:
    def __init__(self, hub: LockstepAllToAll, rank: int):
        self.hub, self.rank, self.size = hub, rank, hub.size

    def all_to_all(self, x):
        h = self.hub
        h._slots[self.rank] = x
        h._barrier.wait()
        out = torch.stack([h._slots[j][self.rank] for j in range(self.size)])
        h._barrier.wait()
        return out


def run_lockstep(n: int, fn):
    """Run fn(rank, comm) on n threads of a `LockstepAllToAll`
    (ring_attention.run_lockstep's runner): the results in rank order."""
    return ring_attention.run_lockstep(n, fn, LockstepAllToAll(n))
