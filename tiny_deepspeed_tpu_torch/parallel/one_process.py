# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Every rank of a model / expert group run in turn in one process.

A harness, not a training path: chip_smoke.py's phase 17 holds a
layout's shards against the whole model on one card this way, and the
CPU tests do the same without spawning.  The engines never import it.

- `LocalReduce(rank, size)`: a communicator whose `all_reduce` returns
  x as it is, so each shard's call yields its own partial (one shard
  timed alone);
- `lockstep(size, fn, known)`: the ranks' work as the group would
  compute it, every all-reduce a true SUM or MAX over the ranks' inputs
  (`mesh.GroupReduce`'s contract), forward and backward alike.
"""

from __future__ import annotations

from typing import List, Optional

import torch


class LocalReduce:
    """A communicator for one shard run alone: `all_reduce` returns x as
    it is (the shard's own partial).  `rank` / `size` place the shard in
    its group."""

    def __init__(self, rank: int, size: int):
        self.rank, self.size = int(rank), int(size)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return x


class _Replay:
    """One rank's communicator of a `lockstep` pass: the all-reduces
    already settled return their result; the first one not settled
    records this rank's input and, like every later one, returns the
    input itself (the pass's later values are not used).  `all_reduce`
    reduces over every rank of the pass, `group(members)`'s over the
    listed ranks only (a model or an expert group of a (model, expert)
    split).  `calls` and `nbytes` count the all-reduces and the bytes of
    their inputs."""

    def __init__(self, rank: int, size: int, known: List):
        self.rank, self.size = rank, size
        self.known = known
        self.calls = 0
        self.nbytes = 0
        self.fresh = None

    def group(self, members) -> "_Group":
        return _Group(self, tuple(members))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self._reduce(x, op, tuple(range(self.size)))

    def _reduce(self, x, op, members):
        i = self.calls
        self.calls += 1
        self.nbytes += x.numel() * x.element_size()
        if i < len(self.known):
            return self.known[i][self.rank].clone()
        if i == len(self.known):
            self.fresh = (op, members, x.detach().clone())
        return x


class _Group:
    """A `_Replay` rank's communicator over the ranks `members`."""

    def __init__(self, replay: _Replay, members):
        self.replay, self.members = replay, members
        self.rank, self.size = members.index(replay.rank), len(members)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.replay._reduce(x, op, self.members)


def lockstep(size: int, fn, known: Optional[List] = None):
    """[fn(comm_r) for r in range(size)] as the ranks would compute it,
    in one process: fn runs one rank's work (a forward, or a forward and
    its backward) on its communicator.  Pass after pass, every rank's
    input to the first all-reduce not yet settled is reduced (SUM or MAX
    over the rank's group, as the groups would), until a pass meets no
    new one; that last pass's results are returned, its autograd graphs
    intact.  fn must issue the same all-reduces, in the same order, on
    every pass and every rank (each pass settles one more: k dependent
    reduces take k + 1 passes).  `known`, a list, keeps the settled
    results across calls: a second call with it runs one pass."""
    known = [] if known is None else known
    while True:
        comms = [_Replay(r, size, known) for r in range(size)]
        outs = [fn(c) for c in comms]
        fresh = [c.fresh for c in comms]
        if all(f is None for f in fresh):
            return outs
        if any(f is None or f[0] != fresh[0][0] for f in fresh):
            raise RuntimeError("lockstep: the ranks' all-reduces differ")
        got = []
        for r, (op, members, _) in enumerate(fresh):
            if any(fresh[q][1] != members for q in members):
                raise RuntimeError("lockstep: the ranks' groups differ")
            xs = torch.stack([fresh[q][2] for q in members])
            got.append(xs.sum(0) if op == "sum" else xs.amax(0))
        known.append(got)
