# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Token batches and the tokenizers (counterpart of
`tiny_deepspeed_tpu/data/`)."""

from . import tokenizer
from .loader import TokenLoader, rank_block

__all__ = ["TokenLoader", "rank_block", "tokenizer"]
