# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Process-group bring-up and the (data, seq) rank layout.

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
- `make_context(seq_parallel, seq_impl)` lays the world out as the JAX
  engine's mesh `(data, seq)` with seq fastest, `rank = d * SP + s`
  (parallel/engine.py:469-477 there), and creates one seq group per data
  index and one data group per seq index.  `new_group` is collective:
  every rank creates every group, in the same order.
- `ParallelContext` carries both groups, both sizes, this rank's
  coordinates, the sequence split's implementation and the seq group's
  communicator — a `GroupRing` for the ring, a `GroupAllToAll` for
  Ulysses — what the model's forward and the engine's collectives
  need.
- `granule_map` / `granule_geometry` (JAX :224-251): the link hierarchy
  hpZ keys on.  On a TPU a granule is a DCN slice; here it is a host
  (ranks on one host share NVLink, hosts share the network): the map is
  {data rank: host index}, None on one host.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """This rank's place in the (data, seq) layout and its groups.

    `data_group` runs the ZeRO stage's collective, `seq_group` the
    sequence split's collectives (None when seq_size == 1),
    `world_group` the loss and the init broadcast.  `seq_impl` is "ring"
    or "ulysses"; `seq_comm` is the seq group's `GroupRing` under the
    ring, its `GroupAllToAll` under Ulysses.  `gather` is ZeRO-3's
    weight gather (parallel/zero3.py), which the model's forward calls;
    None under the other engines."""

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

    @property
    def is_multi_device(self) -> bool:
        return self.world > 1


def make_context(seq_parallel: int = 1, seq_impl: str = "ring"
                 ) -> ParallelContext:
    """The (data, seq) context of this rank over the default group, which
    must exist (`init_distributed`).  seq_parallel must divide the world
    size; seq_impl is "ring" or "ulysses" (inert without a seq split).
    Collective: every rank calls it with the same arguments."""
    if seq_impl not in ("ring", "ulysses"):
        raise ValueError(f"seq_impl must be 'ring' or 'ulysses', "
                         f"got {seq_impl!r}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() (or "
                           "torch.distributed.init_process_group) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    sp = int(seq_parallel)
    if sp < 1 or world % sp:
        raise ValueError(f"seq_parallel={sp} must divide the world size "
                         f"{world}")
    dp = world // sp
    d, s = divmod(rank, sp)
    if sp == 1:
        data_group, seq_group = dist.group.WORLD, None
    else:
        data_group = seq_group = None
        for si in range(sp):  # one data group per seq index
            g = dist.new_group([di * sp + si for di in range(dp)])
            if si == s:
                data_group = g
        for di in range(dp):  # one seq group per data index
            g = dist.new_group([di * sp + si for si in range(sp)])
            if di == d:
                seq_group = g
    comm = None
    if seq_group is not None:
        comm = (GroupAllToAll if seq_impl == "ulysses" else GroupRing)(
            seq_group)
    return ParallelContext(
        world=world, rank=rank, data_size=dp, seq_size=sp, data_rank=d,
        seq_rank=s, data_group=data_group, seq_group=seq_group,
        world_group=dist.group.WORLD, seq_comm=comm, seq_impl=seq_impl)


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
