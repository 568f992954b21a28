# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Optimizer-state offload: the moments rest in host memory and stream
through the device one leaf at a time for the update.

Counterpart of the JAX engine's `offload_opt_state` placement and its
`_offload_update` (`tiny_deepspeed_tpu/parallel/engine.py:1070-1131`):

- at rest, every per-leaf slot of `opt_state["state"]` (AdamW's m and
  v, SGD's velocity) is a host tensor — pinned memory when the engine
  runs on the card, a separate CPU tensor on the CPU, so the same
  streaming code runs there.  The step counter stays where it is;
- `MomentStream.stream(state, names)` yields (name, the leaf's slots on
  the device) in order: each leaf's inbound copy runs on a side stream,
  the caller's update on the compute stream after it, and the outbound
  copy back into the same host tensors on a second side stream after
  the update, ordered by events.  Leaf i's inbound copy waits on leaf
  i - W's outbound copy (W = `offload_prefetch`), as JAX chains its
  copies through `optimization_barrier`: at most W leaves' moments are
  on the device at once.  At W >= 2 leaf i+1's inbound copy may run
  under leaf i's update and outbound copy.  The window counts leaves,
  not bytes: where a small leaf (a bias) sits between two large ones, as
  in GPT-2's order, the second large leaf's inbound copy runs under the
  first one's outbound copy only from W = 3 on.  The compute stream
  waits for the last outbound copy before the step returns, so a host
  read after a device sync sees the new moments.

The update is the optimizer's `update_one` on the device copies: bit for
bit the update on resting device moments.  Device buffers are allocated
on the inbound stream and marked used by the compute and outbound
streams (`record_stream`), so the caching allocator does not hand one
out again before those streams are done with it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Tuple

import torch


class MomentStream:
    """The offloaded moments' placement and streaming for one engine:
    `window` leaves in flight on `device`."""

    def __init__(self, window: int, device: torch.device):
        self.window = int(window)
        self.device = device
        self._streams = None  # (inbound, outbound), made at first use

    # -- placement -----------------------------------------------------------

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of t: pinned memory for the card, a separate CPU
        tensor on the CPU."""
        if self.device.type == "cuda":
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t)
            return out
        return t.detach().clone()

    def host_slots(self, slots: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        return {k: self.to_host(t) for k, t in slots.items()}

    def host_state(self, state: Dict[str, Dict[str, torch.Tensor]]):
        """Every leaf's slots moved to host memory, leaf by leaf."""
        return {n: self.host_slots(s) for n, s in state.items()}

    def wait(self) -> None:
        """Block the host until the last outbound copies have landed."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- streaming -----------------------------------------------------------

    def stream(self, state: Dict[str, Dict[str, torch.Tensor]],
               names: Iterable[str]
               ) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
        """(name, its slots on the device) for each name in order; the
        caller updates the slots in place before asking for the next, and
        the new values are copied back into `state`'s host tensors."""
        names = list(names)
        if self.device.type != "cuda":
            for n in names:
                dev = {k: h.clone() for k, h in state[n].items()}
                yield n, dev
                for k, h in state[n].items():
                    h.copy_(dev[k])
            return
        yield from self._stream_cuda(state, names)

    def _stream_cuda(self, state, names):
        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        ins, outs = self._streams
        cur = torch.cuda.current_stream(self.device)
        # the host tensors were last written by the outbound stream
        ins.wait_stream(outs)
        w, n_leaves = self.window, len(names)
        dev = [None] * n_leaves
        in_ev = [None] * n_leaves
        out_ev = [None] * n_leaves

        def inbound(i):
            with torch.cuda.stream(ins):
                if i >= w:
                    ins.wait_event(out_ev[i - w])
                dev[i] = {k: torch.empty(h.shape, dtype=h.dtype,
                                         device=self.device).copy_(
                                             h, non_blocking=True)
                          for k, h in state[names[i]].items()}
                in_ev[i] = torch.cuda.Event()
                in_ev[i].record(ins)

        for i in range(min(w, n_leaves)):
            inbound(i)
        for i, n in enumerate(names):
            cur.wait_event(in_ev[i])
            yield n, dev[i]
            done = torch.cuda.Event()
            done.record(cur)
            with torch.cuda.stream(outs):
                outs.wait_event(done)
                for k, h in state[n].items():
                    h.copy_(dev[i][k], non_blocking=True)
                out_ev[i] = torch.cuda.Event()
                out_ev[i].record(outs)
            for t in dev[i].values():
                t.record_stream(cur)
                t.record_stream(outs)
            dev[i] = None
            if i + w < n_leaves:
                inbound(i + w)
        cur.wait_stream(outs)
