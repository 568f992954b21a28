# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The model families: GPT-2 and Llama (counterpart of the JAX package's
`models/__init__.py`; its MoE family is not ported yet)."""

from .gpt2 import GPT2_PRESETS, GPT2Model, GPTConfig, resolved_cache_dtype
from .llama import LLAMA_PRESETS, LlamaConfig, LlamaModel

# one flat preset namespace across families (tiny / gpt2-* / llama-*)
ALL_PRESETS = {**GPT2_PRESETS, **LLAMA_PRESETS}


def build_model(name_or_cfg, device=None):
    """A model from a preset name or a config, on `device` (the card
    unless "cpu" is given); the family follows the config's type (JAX
    :16-27)."""
    cfg = (ALL_PRESETS[name_or_cfg] if isinstance(name_or_cfg, str)
           else name_or_cfg)
    if isinstance(cfg, LlamaConfig):
        return LlamaModel(cfg, device=device)
    return GPT2Model(cfg, device=device)


__all__ = ["ALL_PRESETS", "GPT2_PRESETS", "GPT2Model", "GPTConfig",
           "LLAMA_PRESETS", "LlamaConfig", "LlamaModel", "build_model",
           "resolved_cache_dtype"]
