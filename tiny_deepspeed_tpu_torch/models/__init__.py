# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

from .gpt2 import GPT2_PRESETS, GPT2Model, GPTConfig, resolved_cache_dtype

__all__ = ["GPT2_PRESETS", "GPT2Model", "GPTConfig", "resolved_cache_dtype"]
