# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Text <-> token ids: the port's own copy of the JAX package's
`data/tokenizer.py` (:37-66).

  * "byte" — raw UTF-8 bytes, vocab 256, always available; pair with
    models whose vocab_size >= 256.
  * "gpt2" — needs the HuggingFace tokenizer files in the local cache;
    without them it raises with the JAX package's message.
"""

from __future__ import annotations

import numpy as np

TOKENIZERS = ("byte", "gpt2")


def _gpt2_tok():
    try:
        from transformers import GPT2TokenizerFast
        return GPT2TokenizerFast.from_pretrained("gpt2",
                                                 local_files_only=True)
    except Exception as e:  # noqa: BLE001 - explain the offline gate
        raise RuntimeError(
            "the gpt2 tokenizer needs its files in the local HuggingFace "
            f"cache (this environment has no network): {e!r}\n"
            "Use the byte tokenizer instead.") from e


def encode(text: str, tokenizer: str = "byte") -> np.ndarray:
    """Text -> uint16 token ids (the .bin / TokenLoader convention)."""
    if tokenizer == "byte":
        return np.frombuffer(text.encode("utf-8"),
                             dtype=np.uint8).astype(np.uint16)
    if tokenizer == "gpt2":
        return np.asarray(_gpt2_tok()(text)["input_ids"], dtype=np.uint16)
    raise ValueError(f"unknown tokenizer {tokenizer!r}; "
                     f"choose from {TOKENIZERS}")


def decode(ids, tokenizer: str = "byte") -> str:
    """Token ids -> text.  Byte-tokenizer ids outside [0, 256) render as
    '?' rather than raising."""
    ids = np.asarray(ids)
    if tokenizer == "byte":
        return bytes(int(t) if 0 <= int(t) < 256 else 0x3F
                     for t in ids).decode("utf-8", errors="replace")
    if tokenizer == "gpt2":
        return _gpt2_tok().decode([int(t) for t in ids])
    raise ValueError(f"unknown tokenizer {tokenizer!r}; "
                     f"choose from {TOKENIZERS}")


def min_vocab(tokenizer: str) -> int:
    """The smallest model vocab_size the tokenizer's ids fit in."""
    return {"byte": 256, "gpt2": 50257}[tokenizer]
