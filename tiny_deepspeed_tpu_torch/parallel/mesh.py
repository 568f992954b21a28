# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Process-group bring-up and the (data, seq, model, expert) rank layout.

Counterpart of `tiny_deepspeed_tpu/parallel/mesh.py`: `init_distributed`
(:34), `make_mesh` (:70) and `ParallelContext` (:149-222).  A JAX mesh is
one program over every device; here each rank is a process and the mesh
is a set of `torch.distributed` process groups:

- `init_distributed()` brings the default group up from torchrun's
  environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
  `MASTER_PORT`), or as a world of one without it.  On the card it pins
  the rank to `cuda:LOCAL_RANK` BEFORE the group exists and takes NCCL;
  with `device="cpu"` it takes gloo.  The port never stages the card's
  traffic through the host: gloo with CUDA tensors raises.
- `make_context(seq_parallel, seq_impl, tensor_parallel,
  expert_parallel)` lays the world out as the JAX engine's mesh `(data,
  seq, model, expert)`, the last fastest, `rank = ((d*SP + s)*TP + m)*EP
  + e` (parallel/engine.py:455-478 there; an axis of size 1 is absent
  there and inert here), and creates one data group per (s, m, e), one
  seq group per (d, m, e), one model group per (d, s, e), one expert
  group per (d, s, m) and, under both, one (model x expert) group per
  (d, s).  `new_group` is collective: every rank creates every group, in
  the same order.
- `ParallelContext` carries the groups, the sizes, this rank's
  coordinates, the sequence split's implementation and the seq group's
  communicator — a `GroupRing` for the ring, a `GroupAllToAll` for
  Ulysses — and the model / expert / (model x expert) groups'
  `GroupReduce` communicators (parallel/tensor.py's collectives go
  through them), what the model's forward and the engine's collectives
  need.
- `granule_map` / `granule_geometry` (JAX :224-251): the link hierarchy
  hpZ keys on.  On a TPU a granule is a DCN slice; here it is a host
  (ranks on one host share NVLink, hosts share the network): the map is
  {data rank: host index}, None on one host.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import socket
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

from ..ops.dispatch import resolve_device


def init_distributed(device: Union[None, str, torch.device] = None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Bring up the default process group (once; later calls return at
    once) and return the device this rank computes on.

    The device is the card unless `device` says otherwise; under torchrun
    it is `cuda:LOCAL_RANK`, set current before the group is created.
    The backend defaults to NCCL on the card and gloo on the CPU.
    Without torchrun's environment and without `init_method`, the group
    is a world of one over an in-memory store."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if init_method is None and "RANK" in os.environ:
        init_method = "env://"
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(
            backend, init_method=init_method,
            rank=int(os.environ.get("RANK", 0)),
            world_size=int(os.environ.get("WORLD_SIZE", 1)))
    return dev


class GroupRing:
    """Ring communicator over a process group: `rotate(x)` sends x to
    group rank `rank + 1` and returns what group rank `rank - 1` sent, in
    one `batch_isend_irecv` (peers named by global rank).  Every rank of
    the group must call it the same number of times, in the same order."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, self._next, self.group),
                dist.P2POp(dist.irecv, out, self._prev, self.group)]):
            req.wait()
        return out


class GroupAllToAll:
    """All-to-all communicator over a process group (Ulysses):
    `all_to_all(x)` takes x (n, ...) — slice j for group rank j — and
    returns (n, ...) whose slice j came from group rank j, in one
    `all_to_all_single` (gloo on the CPU, NCCL on the card).  Every rank
    of the group must call it the same number of times, in the same
    order, with the same shape."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out


class GroupReduce:
    """All-reduce communicator over a process group (tensor and expert
    parallelism): `all_reduce(x, op)` returns the group's SUM ("sum") or
    MAX ("max") of x as a new tensor; x is not written.  `rank` and
    `size` are this rank's place in the group.  Every rank of the group
    must call it the same number of times, in the same order, with the
    same shape.  parallel/one_process.py stands in for it where one
    process runs every shard in turn."""

    _OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, op=self._OPS[op], group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """This rank's place in the (data, seq, model, expert) layout and
    its groups.

    `data_group` runs the ZeRO stage's collective, `seq_group` the
    sequence split's collectives (None when seq_size == 1),
    `world_group` the loss and the init broadcast.  `seq_impl` is "ring"
    or "ulysses"; `seq_comm` is the seq group's `GroupRing` under the
    ring, its `GroupAllToAll` under Ulysses.  `model_comm`,
    `expert_comm` and `mxe_comm` are the `GroupReduce` communicators of
    the model group, the expert group and the (model x expert) group
    (each None when its axis, or one of its axes, has size 1).  `tp` is
    the engine's `tensor.TPLayout` (None without TP / EP): which leaves
    are cut and how.  `gather` is ZeRO-3's weight gather
    (parallel/zero3.py), which the model's forward calls; None under the
    other engines."""

    world: int
    rank: int
    data_size: int
    seq_size: int
    data_rank: int
    seq_rank: int
    data_group: Any = None
    seq_group: Any = None
    world_group: Any = None
    seq_comm: Any = None
    gather: Any = None
    seq_impl: str = "ring"
    model_size: int = 1
    expert_size: int = 1
    model_rank: int = 0
    expert_rank: int = 0
    model_group: Any = None
    expert_group: Any = None
    model_comm: Any = None
    expert_comm: Any = None
    mxe_comm: Any = None
    tp: Any = None

    @property
    def is_multi_device(self) -> bool:
        return self.world > 1

    @property
    def tensor_parallel(self) -> bool:
        return self.model_size > 1

    @property
    def expert_parallel(self) -> bool:
        return self.expert_size > 1

    @property
    def batch_ranks(self) -> int:
        """The ranks that hold different blocks of the global batch:
        data x seq (a model or expert rank repeats its (d, s) block)."""
        return self.data_size * self.seq_size

    def rank_of(self, d: int, s: int, m: int = 0, e: int = 0) -> int:
        """The global rank at coordinates (d, s, m, e)."""
        return ((d * self.seq_size + s) * self.model_size + m) \
            * self.expert_size + e


def make_context(seq_parallel: int = 1, seq_impl: str = "ring",
                 tensor_parallel: int = 1, expert_parallel: int = 1
                 ) -> ParallelContext:
    """The (data, seq, model, expert) context of this rank over the
    default group, which must exist (`init_distributed`).  The product
    of the split sizes must divide the world size (JAX's check and
    message); seq_impl is "ring" or "ulysses" (inert without a seq
    split).  Collective: every rank calls it with the same arguments."""
    if seq_impl not in ("ring", "ulysses"):
        raise ValueError(f"seq_impl must be 'ring' or 'ulysses', "
                         f"got {seq_impl!r}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() (or "
                           "torch.distributed.init_process_group) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    sp, tp, ep = int(seq_parallel), int(tensor_parallel), int(expert_parallel)
    if min(sp, tp, ep) < 1 or world % (sp * tp * ep):
        # pipeline_parallel is refused before this point: always 1 here
        raise ValueError(
            f"seq_parallel={sp} * tensor_parallel={tp} * "
            f"expert_parallel={ep} * pipeline_parallel=1 must divide "
            f"device count {world}")
    dp = world // (sp * tp * ep)
    sizes = (dp, sp, tp, ep)
    coords, r = [], rank
    for n in reversed(sizes):
        r, c = divmod(r, n)
        coords.append(c)
    d, s, m, e = reversed(coords)
    mine = (d, s, m, e)

    def of(c):
        return ((c[0] * sp + c[1]) * tp + c[2]) * ep + c[3]

    def groups(axes, always=False):
        """One group per index of the other axes, over `axes` (every rank
        creates every group, in one order); this rank's.  None when the
        axes span one rank, unless `always`; the default group when they
        span the world."""
        if math.prod(sizes[a] for a in axes) == 1 and not always:
            return None
        if math.prod(sizes[a] for a in axes) == world:
            return dist.group.WORLD
        out = None
        rest = [a for a in range(4) if a not in axes]
        for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
            members = []
            for var in itertools.product(*(range(sizes[a]) for a in axes)):
                c = [0] * 4
                for a, v in zip(rest, fixed):
                    c[a] = v
                for a, v in zip(axes, var):
                    c[a] = v
                members.append(of(c))
            g = dist.new_group(sorted(members))
            if all(mine[a] == v for a, v in zip(rest, fixed)):
                out = g
        return out

    # the data groups first, then the seq groups (the order of the
    # layout before the model and expert axes), then the new ones
    data_group = groups((0,), always=True)
    seq_group = groups((1,))
    model_group = groups((2,))
    expert_group = groups((3,))
    mxe_group = groups((2, 3)) if tp > 1 and ep > 1 else None
    comm = None
    if seq_group is not None:
        comm = (GroupAllToAll if seq_impl == "ulysses" else GroupRing)(
            seq_group)
    return ParallelContext(
        world=world, rank=rank, data_size=dp, seq_size=sp, data_rank=d,
        seq_rank=s, data_group=data_group, seq_group=seq_group,
        world_group=dist.group.WORLD, seq_comm=comm, seq_impl=seq_impl,
        model_size=tp, expert_size=ep, model_rank=m, expert_rank=e,
        model_group=model_group, expert_group=expert_group,
        model_comm=GroupReduce(model_group) if model_group else None,
        expert_comm=GroupReduce(expert_group) if expert_group else None,
        mxe_comm=GroupReduce(mxe_group) if mxe_group else None)


def granule_map(pctx: ParallelContext) -> Optional[Dict[int, int]]:
    """{data rank: granule index} over `pctx`'s data group, a granule
    being a host (its name), indexed in order of first appearance along
    the data axis; None when every data rank is on one host.
    Collective over the data group."""
    names = [None] * pctx.data_size
    dist.all_gather_object(names, socket.gethostname(),
                           group=pctx.data_group)
    ix: Dict[str, int] = {}
    for n in names:
        ix.setdefault(n, len(ix))
    if len(ix) <= 1:
        return None
    return {r: ix[n] for r, n in enumerate(names)}


def granule_geometry(granule_of: Optional[dict], n: int) -> tuple:
    """(n_granules, ici) of a granule map over an n-rank data axis (JAX
    mesh.py:240): a None / empty map is one granule, (1, n); `ici` is the
    ranks a granule when the granules split n evenly, else n."""
    if not granule_of:
        return 1, n
    n_gran = len(set(granule_of.values()))
    if n_gran <= 1 or n % n_gran:
        return max(n_gran, 1), n
    return n_gran, n // n_gran
