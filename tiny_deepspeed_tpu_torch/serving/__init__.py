# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Serving tier of the port: continuous batching over a paged KV pool.

  * `pool`    — paged KV block pool + block tables (in-place writers),
                int8/fp8 cache blocks
  * `engine`  — ServingEngine: prefill/decode split, admission, eviction,
                preemption, deadline shedding/expiry, warm restart
  * `guard`   — decode-health guard: per-slot non-finite quarantine + the
                warm-restart watchdog
  * `spec`    — speculative decoding: one verify step scoring K+1 draft
                span positions per slot per tick
  * `drafter` — draft proposers: model-free prompt lookup ("ngram") and
                a same-family draft model ("model:<preset>",
                "model:self")
  * `prefix`  — shared-prefix KV reuse: refcounted radix tree of
                committed full blocks; admission aliases matched blocks
                and prefills only the suffix
"""

from .drafter import ModelDrafter, NgramDrafter, make_drafter
from .engine import Request, ServeConfig, ServingEngine
from .guard import DecodeHealthGuard
from .pool import KV_QUANT_MODES, KVPoolView, PagedKVPool, PageRef
from .prefix import PrefixCache
from .spec import MAX_SPEC_K, SpecDecoder

__all__ = ["Request", "ServeConfig", "ServingEngine", "DecodeHealthGuard",
           "KV_QUANT_MODES", "KVPoolView", "PagedKVPool", "PageRef",
           "SpecDecoder", "MAX_SPEC_K", "NgramDrafter", "ModelDrafter",
           "make_drafter", "PrefixCache"]
