# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""tiny-deepspeed-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`tiny_deepspeed_tpu`, the
reference).  It imports torch and never jax, and nothing of the JAX
package.  Module names mirror the JAX package's so each counterpart is
easy to find.  This first slice is the serving path: GPT-2
continuous-batching inference over a paged KV pool, with the three Pallas
kernels of that path rewritten for Hopper (ops/layernorm.py in Triton,
csrc/flash_fwd.cu and csrc/paged_attn.cu in CUDA C++).

Entry points run on the card unless the caller passes device="cpu";
without CUDA and without a device they raise.
"""

from .convert import params_from_numpy, params_to_numpy
from .models.gpt2 import GPT2_PRESETS, GPT2Model, GPTConfig
from .serving.engine import ServeConfig, ServingEngine

__all__ = ["GPTConfig", "GPT2_PRESETS", "GPT2Model", "ServeConfig",
           "ServingEngine", "params_from_numpy", "params_to_numpy"]
