# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""tiny-deepspeed-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`tiny_deepspeed_tpu`, the
reference).  It imports torch and never jax, and nothing of the JAX
package.  Module names mirror the JAX package's so each counterpart is
easy to find.  Ported so far:

- slice 1, serving: GPT-2 continuous-batching inference over a paged KV
  pool (`ServingEngine`);
- slice 2, single-device training: `SingleDevice` over `GPT2Model`'s
  loss with `AdamW` / `SGD` and the JAX package's `TokenLoader` stream
  (`python -m tiny_deepspeed_tpu_torch.train`);
- slice 3, its knobs: the fused (`fused_xent_impl="pallas"`) and chunked
  lm_head + loss heads, `AdamW(fused=True)` and dropout.

Every Pallas kernel those paths run on a TPU is rewritten for Hopper:
layernorm forward, dx and dw/db in Triton (ops/layernorm.py); the fused
AdamW update in Triton (optim/adamw_fused.py); FA2 causal forward, dq
and dk/dv (csrc/flash_fwd.cu, csrc/flash_bwd.cu), paged decode attention
(csrc/paged_attn.cu) and the fused lm_head + cross-entropy forward, dx
and dW (csrc/fused_xent.cu) in CUDA C++.

Entry points run on the card unless the caller passes device="cpu";
without CUDA and without a device they raise.
"""

from .convert import (opt_state_from_numpy, opt_state_to_numpy,
                      params_from_numpy, params_to_numpy)
from .data import TokenLoader
from .models.gpt2 import (GPT2_PRESETS, GPT2Model, GPTConfig,
                          effective_xent_impl)
from .optim import SGD, AdamW
from .parallel import SingleDevice, TrainState
from .serving.engine import ServeConfig, ServingEngine

__all__ = ["AdamW", "GPTConfig", "GPT2_PRESETS", "GPT2Model", "SGD",
           "ServeConfig", "ServingEngine", "SingleDevice", "TokenLoader",
           "TrainState", "effective_xent_impl", "opt_state_from_numpy", "opt_state_to_numpy",
           "params_from_numpy", "params_to_numpy"]
