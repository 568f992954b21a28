# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Megatron's f and g: the autograd edges of a model-parallel region.

Where the JAX engines let GSPMD insert the collectives of the "model" and
"expert" axes, the port's models call these two around their split
products (parallel/tensor.py has the layout):

- `copy_to(x, comm)`: forward identity, backward the group's SUM — x
  entering a column-parallel product, each rank's product giving a
  partial gradient;
- `reduce_from(x, comm)`: forward the group's SUM, backward identity — a
  row-parallel product's partial output leaving.

`comm` is the group's communicator (`parallel.mesh.GroupReduce`, or a
stand-in with the same `all_reduce(x, op)`); both are x itself when it is
None.  No kernel: the collectives are NCCL's (gloo's on the CPU).
"""

from __future__ import annotations

import torch


class _CopyTo(torch.autograd.Function):
    """Forward identity; backward the group's SUM (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, "sum"), None


class _ReduceFrom(torch.autograd.Function):
    """Forward the group's SUM; backward identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, comm) -> torch.Tensor:
    """x entering a model-parallel region over `comm`'s group: the same
    forward, its gradient summed over the group (each rank's product
    gives a partial).  Identity when `comm` is None."""
    return x if comm is None else _CopyTo.apply(x, comm)


def reduce_from(x: torch.Tensor, comm) -> torch.Tensor:
    """A row-parallel product's partial output SUMmed over `comm`'s
    group; the gradient passes as it is.  Identity when `comm` is None."""
    return x if comm is None else _ReduceFrom.apply(x, comm)
