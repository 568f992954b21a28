# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Cache rank map: name-ordered greedy parameter -> rank partition table.

The port's own copy of `tiny_deepspeed_tpu/parallel/partition.py::
partition_tensors` and `partition_sizes` (:38-116), pure Python.  Given
the name-ordered parameter list, each tensor goes to one of `num_parts`
ranks by a greedy CONTIGUOUS walk; `evenness_priority` in [0, 1] trades
contiguity against numel balance through a dynamic cut threshold.

The table is an ownership report (`ZeroEngine.rank_map`), as in the JAX
package: the engines' physical layout is a flat, padded, per-leaf shard
(parallel/engine.py), not whole tensors per owner.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Sequence, Tuple, Union


def _numel(x) -> int:
    shape = getattr(x, "shape", x)
    return int(math.prod(shape)) if shape else 1


def partition_tensors(
    named_tensors,
    num_parts: Union[int, Sequence[int]],
    evenness_priority: float = 0.0,
    verbose: bool = False,
) -> Dict[str, int]:
    """Return {param_name: part_index}.

    named_tensors: a dict name -> tensor / shape tuple, or an iterable of
    (name, tensor) pairs.  num_parts: the number of ranks, or a sequence
    of rank ids whose length is used.  evenness_priority: 0.0 cuts parts
    as late as possible (maximal contiguity), 1.0 never overshoots the
    ideal per-part numel (maximal evenness).  verbose prints the per-part
    numel summary."""
    if not isinstance(num_parts, int):
        num_parts = len(list(num_parts))
    if num_parts < 1:
        raise ValueError("num_parts must be >= 1")
    if not 0.0 <= evenness_priority <= 1.0:
        raise ValueError("evenness_priority must be in [0, 1]")

    items: List[Tuple[str, int]] = [
        (name, _numel(t))
        for name, t in (named_tensors.items()
                        if isinstance(named_tensors, dict)
                        else named_tensors)
    ]
    total = sum(n for _, n in items)
    ideal = total / num_parts if num_parts else 0

    table: Dict[str, int] = {}
    part, acc = 0, 0  # acc = numel assigned to parts 0..part so far
    for i, (name, n) in enumerate(items):
        remaining_tensors = len(items) - i
        if part < num_parts - 1:
            boundary = (part + 1) * ideal
            # close the current part before this tensor once acc + e*n
            # crosses the boundary (e = 0: only when already past it; e =
            # 1: whenever the whole tensor would overshoot), or when every
            # remaining tensor is needed to fill the remaining parts
            must_close = remaining_tensors <= (num_parts - 1 - part)
            if must_close or acc + evenness_priority * n > boundary:
                part += 1
        table[name] = part
        acc += n

    sizes = [0] * num_parts
    for name, n in items:
        sizes[table[name]] += n
    for p, s in enumerate(sizes):
        if s == 0:
            warnings.warn(
                f"partition_tensors: part {p} is empty "
                f"({len(items)} tensors into {num_parts} parts)")
    if verbose:
        print(f"partition_tensors: total={total} ideal/part={ideal:.0f} "
              f"sizes={sizes}")
    return table


def partition_sizes(table: Dict[str, int], named_tensors, num_parts: int):
    """Per-part numel totals for a computed table."""
    sizes = [0] * num_parts
    src = (named_tensors.items() if isinstance(named_tensors, dict)
           else named_tensors)
    for name, t in src:
        sizes[table[name]] += _numel(t)
    return sizes
