# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Integer PRNG keys: the port's stand-in for `jax.random` keys.

A key is a 64-bit Python int.  `split` and `fold_in` derive sub-keys by
the splitmix64 finalizer, a deterministic integer mix with the same tree
structure as `jax.random.split` / `jax.random.fold_in`; the bits differ
from JAX's, so the tests hand both sides the same numbers where bits
matter.  Random numbers come from a `torch.Generator` seeded with a key
at the moment of use, on the device that needs them
(models/gpt2.py::_dropout_keep).
"""

from __future__ import annotations

from typing import List

_M64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64: one step of the Weyl sequence, then its finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from `key` and an integer (a step, a layer, a site)."""
    return _mix(_mix(key & _M64) ^ (data & _M64))


def split(key: int, n: int) -> List[int]:
    """n independent keys from `key` (disjoint from its `fold_in` keys
    for data below 2**63)."""
    return [fold_in(key, (1 << 63) | i) for i in range(n)]

