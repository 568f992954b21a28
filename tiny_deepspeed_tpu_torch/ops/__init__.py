# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Ops of the port: plain PyTorch where the JAX package used XLA, and a
hand-written Hopper kernel (Triton or CUDA C++, built at first use) for
each Pallas kernel on the serving path — layernorm forward
(`layernorm.py`), FA2 causal forward (`flash_fa2.py`), paged decode
attention (`paged_attn.py`).  Import the submodules directly; their
function names (`layernorm`, `linear`, `embedding`) would shadow them
here."""
