# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Serving tier of the port: continuous batching over a paged KV pool.

  * `pool`   — paged KV block pool + block tables (in-place writers)
  * `engine` — ServingEngine: prefill/decode split, admission, eviction,
               preemption, deadline shedding/expiry, warm restart
  * `guard`  — decode-health guard: per-slot non-finite quarantine + the
               warm-restart watchdog
"""

from .engine import Request, ServeConfig, ServingEngine
from .guard import DecodeHealthGuard
from .pool import KVPoolView, PagedKVPool, PageRef

__all__ = ["Request", "ServeConfig", "ServingEngine", "DecodeHealthGuard",
           "KVPoolView", "PagedKVPool", "PageRef"]
