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
  lm_head + loss heads, `AdamW(fused=True)` and dropout;
- slice 4, serving features: speculative decoding (`spec_draft`,
  `spec_k`), the shared-prefix cache (`prefix_cache`) and int8 / fp8 KV
  pools (`quant`);
- slice 5, distributed training: `DDP`, `Zero1` and `Zero2` over
  `torch.distributed` (`init_distributed`; NCCL on the card, gloo on the
  CPU) with ring attention over a sequence split (`seq_parallel`), and
  the `partition_tensors` rank map (`python -m torch.distributed.run
  -m tiny_deepspeed_tpu_torch.train --engine zero2 ...`);
- slice 6, ZeRO-3: `Zero3`, params sharded at rest and gathered per
  layer, with the fp8 weight gather (`GPTConfig(gather_quant="fp8")`,
  also under the other engines and in serving), and the heads-last FA2
  entry `ops.flash_fa2.fa2_flash_attention_bthd` with its A/B
  (`python -m tiny_deepspeed_tpu_torch.fa2_bthd_ab`);
- slice 15, the Llama family: `LlamaModel` (RMSNorm, RoPE, SwiGLU,
  grouped K/V) served and trained through the same entry points,
  `build_model` / `ALL_PRESETS` over both families
  (`python -m tiny_deepspeed_tpu_torch.train --model llama-160m`);
- slice 16, the MoE family: `MoEGPT` (top-k routed experts, both
  dispatches, routing global across ranks as JAX's GSPMD routes it)
  trained under every engine (`python -m tiny_deepspeed_tpu_torch.train
  --model moe-8x124m [--moe-dispatch sort]`); serving refuses it, as
  JAX's does;
- slice 17, sampling and checkpoints: `GPT2Model.generate` for every
  family over a private paged pool (`python -m
  tiny_deepspeed_tpu_torch.generate [--ckpt DIR]`, the byte tokenizer in
  `data/tokenizer.py`), and atomic per-rank save / resume under every
  engine (`utils/checkpoint.py`; `train --checkpoint-every N --resume`);
- slice 18, the in-step collective schedule: `grad_buckets` (each
  bucket's gradient collective from inside the backward), ZeRO-3's
  `gather_prefetch`, the 2-hop `gather_groups` and `hpz`, validated and
  lowered by one `build_schedule` as JAX's (`parallel/schedule.py`;
  `train --grad-buckets K --gather-prefetch K --sched SPEC`).
- slice 21: the engines' `telemetry=` knob (`telemetry/`: the health
  vector and the per-layer health probe computed in the step, the
  `Telemetry` registry with its flight recorder, JSONL metrics through
  `utils/profiling.MetricsLogger`; `train --telemetry [layers]
  --metrics FILE`), optimizer-state offload (`offload_opt_state`,
  `offload_prefetch`: the moments rest in pinned host memory and stream
  through the card leaf by leaf, `parallel/offload.py`), and dropout
  under the explicit grad lowerings on more than one rank.
- slice 23: the runtime autotuner (`autotuner/`: `RuntimeAutoTuner`,
  `engine.retune()` / `revert_tune()`, `train --autotune [CACHE.json]`)
  and its dispatch sites — `linear`, LayerNorm, the chunked head's
  chunk, the flash site and `AdamW(fused="auto")` — and the fp8 e4m3
  matmuls (`ops/matmul_fp8.py`, `set_fp8_matmul`).

Every Pallas kernel those paths run on a TPU is rewritten for Hopper:
layernorm forward, dx and dw/db in Triton (ops/layernorm.py); the fused
AdamW update and the blockwise int8/fp8 quantizer in Triton
(optim/adamw_fused.py, ops/quant.py); FA2 forward, dq and dk/dv, causal and
unmasked for ring attention's chunks, and heads-last (csrc/flash_fwd.cu,
csrc/flash_bwd.cu), paged attention — decode and
span verify, over bf16 or int8/fp8 pools — (csrc/paged_attn.cu) and the
fused lm_head + cross-entropy forward, dx and dW (csrc/fused_xent.cu) in
CUDA C++.

Entry points run on the card unless the caller passes device="cpu";
without CUDA and without a device they raise.
"""

from .convert import (opt_state_from_numpy, opt_state_to_numpy,
                      params_from_numpy, params_to_numpy)
from .data import TokenLoader
from .models import (ALL_PRESETS, LLAMA_PRESETS, MOE_PRESETS, LlamaConfig,
                     LlamaModel, MoEConfig, MoEGPT, build_model)
from .models.gpt2 import (GPT2_PRESETS, GPT2Model, GPTConfig,
                          effective_xent_impl)
from .optim import SGD, AdamW
from .parallel import (DDP, ScheduleConflictError, SingleDevice,
                       TrainState, Zero1, Zero2, Zero3, ZeroEngine,
                       build_schedule, init_distributed, parse_sched_spec,
                       partition_tensors)
from .serving import PrefixCache, SpecDecoder
from .serving.engine import ServeConfig, ServingEngine
from .telemetry import Telemetry

__all__ = ["ALL_PRESETS", "AdamW", "DDP", "GPTConfig", "GPT2_PRESETS",
           "GPT2Model", "LLAMA_PRESETS", "LlamaConfig", "LlamaModel",
           "MOE_PRESETS", "MoEConfig", "MoEGPT", "PrefixCache", "SGD",
           "ScheduleConflictError", "ServeConfig", "ServingEngine",
           "SingleDevice", "SpecDecoder", "Telemetry", "TokenLoader",
           "TrainState",
           "Zero1", "Zero2", "Zero3", "ZeroEngine", "build_model",
           "build_schedule", "effective_xent_impl",
           "init_distributed", "opt_state_from_numpy", "opt_state_to_numpy",
           "params_from_numpy", "params_to_numpy", "parse_sched_spec",
           "partition_tensors"]
