#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""On-card smoke of the PyTorch port: build, check and time its kernels,
serve gpt2-124m through ServingEngine, train it through SingleDevice, then
serve it again under speculative decoding, the prefix cache and int8/fp8
pools, run the distributed path: ring attention's chunk kernels, the
ring itself and the DDP / ZeRO-1 / ZeRO-2 engines, and ZeRO-3 with the
fp8 weight gather (gpt2-124m and gpt2-1.5b) and the heads-last FA2
kernels through their A/B; then the Llama family: RMSNorm's entries,
llama-160m served and trained; then the MoE family: moe-8x124m trained
with both dispatches; then `generate` on all three families and a
checkpoint's save and resume; the in-step collective schedule and the
grad-comm codecs at world 1; Ulysses on the FA2 kernels and the
counter-based dropout kernel.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels compile for sm_90a) and exits
non-zero, printing no result, without one.  Phases, each on its own line:

  1. the card (`nvidia-smi` name and power limit) and the kernel build —
     nvcc for csrc/*.cu (in parallel) plus the first compile of the
     Triton LayerNorm forward pair rows 1 and 1r replaced (the parent's
     arm below); each CUDA kernel's registers, spill bytes and shared memory
     (ptxas; the tensor-core FA2 kernels' dynamic shared memory beside
     it), and `cuobjdump -sass` proof that every bf16/f16 instantiation of
     the tensor-core FA2 forward, dq and dk/dv kernels, of the fused
     head's forward, dx and dW kernels and of the tensor-core span-verify
     kernel issues HGMMA (wgmma), and no f32 one does (and that the fused
     head's forward and dx and the paged attention kernels do not
     spill, nor the LayerNorm forward's and backward's);
  2. kernel parity: each hand-written kernel against its plain PyTorch
     version on the card at its main paths' shapes (the two forward
     kernels at serving's and at training's; the fused xent kernels also
     at a ragged vocab and at D = 1600; AdamW also at ragged leaves), in
     bf16 (AdamW f32), with the tolerance stated per kernel; the seven
     training kernels also run twice and must agree bit for bit.  The
     slice-4 rows: paged attention over int8 and fp8 pools at the decode
     shape, its span-verify variant at the speculative shape (K1=5) and
     the suffix-prefill shape (K1=256) over bf16 and int8 pools (atol =
     rtol = 2e-2), decode also at a long context (pos to 4000, W = 256),
     and the blockwise quantizer at the KV append, prefill
     and grad-comm shapes (codes and scales bit-identical).  The slice-11
     rows: the KV-pool write (10kv, csrc/kv_write.cu) at the decode,
     span-commit and prefill writers' shapes over bf16, f32, int8 and
     e4m3 pools — pool bytes and scales on blocks 1.. bit-identical to
     the unfused writers (the quantizer kernel and index writes), one
     launch a call — timed against that unfused sequence (device time,
     in turns, and host `call_ms`).  The slice-13 rows 1 and 1r:
     LayerNorm's forward and the residual add + forward behind one C
     entry (csrc/ln_fwd.cu) at 8, 40, 512, 8192 rows of 768 and 8192 of
     1600 in bf16, f32 and f16 (row 1 also an f32 weight under bf16 x):
     against their plain versions, one launch a call, repeatable, 1r's
     s, y, mean, rstd and gradients bit for bit `x + r` then row 1, and
     whether each is bit-identical to the Triton kernel it replaced
     (`_ln_fwd_triton`, `_add_ln_fwd_triton`, held to the plain version
     too); then at 8, 512, 8192 x 768 and 8192 x 1600 bf16 three sides
     in turns — the kernel, the Triton kernel, F.layer_norm (after
     `x + r` for 1r) — device and host ms a call.  The slice-14 rows:
     the decode with its append (`paged_attention(append_kv=)`, the
     decode kernel's APPEND instantiation) bit for bit `kv_write` then
     the decode kernel over bf16, f16, f32 (and f32 q over bf16) and int8
     / e4m3 pools, Dh 32, 64 and 128, grouped heads, the split count
     forced to 1-8, offsets 0 and bt - 1 and the table's last position,
     then timed at the decode shape over bf16 and int8 pools in turns
     with those two calls; and the writer (csrc/kv_write.cu) bit for bit
     the v1 kernel (`kv_write_v1`, off every path) at the three writer
     shapes, the prefill read from each layer's own qkv views, timed in
     turns against the v1 kernel, the unfused sequence and (prefill) the
     parent's whole writer, its two stacks then the v1 kernel.  The
     slice-12 row 2+3: LayerNorm's backward in
     one pass (`layernorm_bwd`, csrc/ln_bwd.cu) at 8192 rows of 768 and
     1600 bf16 and of 768 f32 and f16, with and without gs, against
     `_ln_bwd_plain` (2e-2 x max |plain| per output), repeatable, the gs
     variant bit for bit `gs + dx`; the Triton pair it replaced (the
     public `layernorm_dx` / `layernorm_dwdb`) held to its plain
     version; then in turns (kernel, parent, library x 5) at 768 and
     1600 with and without gs against the parent's sequence (the pair,
     the eager `gs + dx`) and F.layer_norm's autograd backward: device
     ms, ratios, host ms per call.  Its
     device time (profiler) stands beside the plain version's, one
     library call's (timed here as a yardstick only; the port never calls
     it) and the bound — the larger of bytes / 3.35 TB/s and flops / the
     H100 SXM dense peak for the inputs' type — and `call_ms` is its
     per-call time with host launch overhead (CUDA events around
     back-to-back calls).  The FA2 rows (4, 4c, 5, 5c, 6, 6c, 7, 8) are
     also timed in turns with their SDPA yardstick (kernel, library,
     library, kernel; 5 repeats of 20 back-to-back calls queued behind a
     sleep, CUDA events): median, min-max spread and kernel / library
     ratio, the number that compares across calls; the fused head's rows
     (11, 12 dx, 12 dW) likewise with F.linear + F.cross_entropy (its
     forward; its backward), and the paged rows (9a-9c) with their
     gather + SDPA call, both rotating the layer.  f32 takes the FMA FA2 kernels (forward, dq,
     dk/dv) and the 3xTF32 fused-head forward, dx and dW, each held to
     its plain version;
  3. serving: gpt2-124m (seeded random weights, bf16 compute) under
     ServingEngine(max_active=8, block_tokens=16) with a pool sized for
     the traffic — 16 greedy requests, seeded prompt lengths 16-512, 64
     new tokens each.  Every kernel's launch count is zeroed just before
     and read just after; each serving kernel must be non-zero.  The first
     request's prefill logits are checked against the plain path on the
     card.  A second, profiled pass of the same traffic gives each
     kernel's device time, reported as a share of the (unprofiled) main
     run's wall.  Every decode launch must carry its layer's append
     (`paged_attention.appends` equal to its launches) and `kv_write`
     launch once a prefill.  Then the decode tick alone (8 requests
     decoding): host ms, launches, device kernels and busy ms a tick, and
     the host ms at each call site (`linear`, which no arm changes, the
     control), with the kernels as they are, with the append apart (the
     parent's tick: its own kv_write launch), with the Triton LayerNorm
     forward pair and with the unfused sequence swapped in, in turns;
  4. training: gpt2-124m at full width and depth (f32 masters, bf16
     compute, remat "dots_no_batch"), SingleDevice + AdamW(lr=1e-5,
     weight_decay=0.1) on the JAX package's synthetic stream, B=8,
     T=1024: 3 warm-up steps, then 10 timed steps with every count zeroed
     just before and read just after (each training kernel non-zero);
     finite losses, the first near ln(50304); one step's gradients on the
     kernel path against the plain path on the card; remat on and off
     bit-identical; 8 steps at lr=1e-3 on one batch lower its loss; one
     profiled step gives each kernel's device time and the device's busy
     and idle shares; the 13 steps again with `add_layernorm` swapped
     for `x + r` then LayerNormFn must give the same losses and params
     bit for bit.  `layernorm_bwd` must launch 25 times a step (12 with
     gs) here and in phases 5, 7c, 8c (8d: 97 a step), the Triton pair
     never, and no profiled step may hold a record of it; then the step
     with `layernorm_bwd` and with the parent's sequence swapped in, two
     engines from one init in turns (6 runs of 10 steps a side): step
     medians, one profiled step a side (busy, idle, the LN backward's
     kernels), losses within 1e-2;
  5. knobbed training: the same model and batch size with the fused
     lm_head + loss kernels (fused_xent_impl="pallas"), AdamW(fused=True)
     and dropout 0.1 — launch counts of the ten training kernels over 10
     timed steps, step time, peak memory and one profiled step as in 4;
     the fused and chunked heads against the default head, the kernel
     path against the plain path, one fused AdamW update against
     fused=False, dropout's determinism, remat invariance and eval, and
     an 8-step fit;
  6. serving variants: gpt2-124m bf16 at full depth, phase 3's 16
     requests under spec_draft="ngram" and "model:self" (spec_k=4) and
     under quant="int8" and "fp8", and a shared-prefix mix (16 requests
     of a 256-token prefix plus a 16-128-token private suffix, 64 new
     tokens each) with the prefix cache on and off.  Every count zeroed
     before each path and read after (a model drafter's launches kept
     apart); every request `ok`; each path's kernels non-zero and no
     other kernel launched; decode tok/s, TTFT p50, device busy and idle
     (a second, profiled pass), acceptance, aliased blocks and prefill
     tokens skipped, `kv_bytes()` beside a bf16 pool's.  One verify
     tick's (S, K1, V) logits and an int8 / fp8 prefill and its first
     decode step against the plain path (5e-2 x max|logit|).  In f32 the
     greedy tokens of plain, spec-ngram and spec-model:self serving must
     be identical, and those of the prefix cache on and off; in bf16 the
     agreement is reported, not gated.  The int8 and fp8 decode ticks
     alone as in phase 3, fused, with the append apart and unfused;
  7. distributed, on the one card:
     a. the unmasked FA2 chunk kernels (4c fwd, 6c dq, 5c dk/dv) at ring
        attention's shape on gpt2-124m with T=1024 over 4 seq ranks (B=8
        H=12 Tl=256 Dh=64 bf16) against their plain versions (atol = rtol
        = 2e-2 forward; 2e-2 x max |plain| backward), each run twice and
        bit-identical, timed beside the bound, the plain version and SDPA
        with no mask (its backward for dq and dk/dv);
     b. ring attention at full width over 4 virtual ranks: 4 threads
        call ring_fwd / ring_bwd directly through a lockstep
        communicator on gpt2-124m's layer-0 q/k/v; the concatenated o,
        dq, dk, dv against the full-sequence causal kernels at T=1024
        (2e-2), and the launches of one attention call equal to JAX's
        schedule (causal fwd, dq, dk/dv 4 each; unmasked 6 each) — the
        chunk kernels' main path (`ring4`);
     c. DDP, Zero1 and Zero2 at world size 1 over NCCL (a file:// store
        under build/chip_smoke/) train gpt2-124m with phase 4's config:
        13 steps whose losses and params must equal phase 4's
        SingleDevice bit for bit; step time, tokens/s and peak memory
        beside phase 4's, one profiled step's NCCL time.  NCCL refuses
        two ranks on one card, so the multi-rank engines are held to the
        JAX engines on the CPU (tests/test_torch_dist*.py).  MoE (after
        8d, in the same group): DDP on moe-8x124m (einsum, phase 4's
        config) 2 steps bit for bit SingleDevice's (`moe_ddp`);
  8. ZeRO-3 and the last two TPU kernels (in 7c's NCCL group):
     a. the heads-last FA2 kernels (#7 fwd, #8 dq and dk/dv) at the A/B's
        shape (B=12 H=12 T=1024 Dh=64 bf16) and at B=8 against their
        plain versions (2e-2, as the other FA2 rows), bit for bit #4 /
        #6 / #5 on the transposed contiguous copies, repeatable; times
        beside the bound, the plain version and SDPA causal on the
        transposed views (forward; forward+backward);
     b. the A/B (`python -m tiny_deepspeed_tpu_torch.fa2_bthd_ab`): both
        arms' fb_ms — the heads-last kernels' main path (`ab`);
     c. Zero3 at world 1 on gpt2-124m with phase 4's config: 13 steps
        bit-identical to phase 4's SingleDevice; then gather_quant="fp8",
        SingleDevice and Zero3 bit-identical to each other and within 5%
        of the unquantized losses at every step; step time, peak memory,
        NCCL / memcpy time;
     d. Zero3 at world 1 on gpt2-1.5b (examples/zero3's default: 48
        layers, 25 heads, n_embd 1600) at B=8 T=1024 (B=4 past 70 GB
        peak): 3 warm-up and 5 timed steps, the first loss in [10.5,
        11.2]; median step time, tokens/s, peak memory, one profiled
        step's busy / idle and kernel classes, and the per-rank state at
        data 4 and 8 from the shard layout (not measured);
     MoE (after 8d): Zero3 on moe-8x124m 2 steps bit for bit
        SingleDevice's (`moe_zero3`), and with the fp8 gather bit for bit
        fp8 SingleDevice's (`moe_zero3_fp8`);
  9. the Llama family (every count zeroed before each path, read after):
     a. RMSNorm's entries, the LayerNorm C entries under their RMS flag
        (rows r1 `rmsnorm_fwd`, r1r `add_rmsnorm_fwd`, r2+3
        `rmsnorm_bwd`, r2+3r its gs launches): against their plain
        versions at 8, 512, 8192 x 768 and 8192 x 2048 bf16, and 8 and
        512 x 768 in f32 and f16 (2e-2 bf16/f16, 1e-5 f32, of the
        output's scale), each twice and bit for bit, s = x + r and the
        gs variant's dx = gs + dx bit for bit; timed at 8192 x 768 (and
        8 x 768: host ms a call; 8192 x 2048: kernel and library in
        turns) beside the bound, the plain version and the library call
        (F.rms_norm; after `x + r`; its autograd backward; `gs + dx`
        after), in turns;
     b. llama-160m (12 layers, 12 query heads over 4 kv heads, Dh 64,
        SwiGLU 2048, seeded random weights, bf16) through ServingEngine:
        phase 3's traffic, then 8 requests under spec-ngram (spec_k 4),
        an int8 pool and the prefix cache — every request ok, each
        decode launch carrying its append, kv_write once a prefill, the
        RMS forwards and never rows 1 / 1r, no kernel off the path; the
        prefill's and the first decode step's logits against the plain
        path (5e-2 x max|logit|); an f32 pass whose plain and
        spec-ngram tokens must be identical; decode tok/s, TTFT p50,
        busy and idle from a profiled pass; the decode tick alone (host
        ms, device records, busy ms, launches), its RoPE and SwiGLU
        launches beside gpt2-124m's phase-3 tick;
     c. llama-160m training with phase 4's config (SingleDevice +
        AdamW(1e-5, wd 0.1), B=8 T=1024, the synthetic stream): 3
        warm-up and 10 timed steps, the first loss in [10.5, 11.2], 25
        RMS backward launches a step (12 with gs); median step time,
        tokens/s, peak memory, one profiled step's busy / idle and
        kernel classes; one step's gradients against the plain path
        (rel L2 <= 5e-2 a leaf), remat on and off bit for bit, 8 steps
        on one batch at lr 1e-3 lowering its loss;
 10. the MoE family: moe-8x124m (gpt2-124m's skeleton, 8 experts of F
     3072 a block, top-2, capacity factor 1.25; seeded random weights)
     trained with phase 4's config (SingleDevice + AdamW(1e-5, wd 0.1),
     remat "dots_no_batch", B=8 T=1024, the synthetic stream), once with
     the "einsum" dispatch and once with "sort": 3 warm-up and 10 timed
     steps, the first loss in [10.5, 11.2], the (token, choice) pairs
     capacity dropped in the first step, the launches of rows 1, 1r,
     2+3, 4-6 equal to phase 4's (250 / 240 / 250 / 240 / 120 / 120 in 10
     steps) and no other kernel; median step time, tokens/s, peak
     memory, one profiled step's busy / idle and its device time by
     class (the routing tables, the dispatch — the einsum path's five
     contractions over the tokens or the sort path's slot gathers and
     sums —, the experts' batched products, the rest); one step's loss
     and gradients against the plain path, which is handed the kernel
     path's expert choices (`moe_routing`; its own must agree on 90% of
     the tokens in every router call), loss 1e-2, rel L2 <= 5e-2 a leaf;
     remat on and off bit for bit (wte as in 9c); then, on one
     batch and the same weights, the einsum loss against the sort loss
     (1e-2);
 11. sampling and checkpoints: a. `generate` (greedy) on gpt2-124m,
     llama-160m and moe-8x124m (bf16, full width and depth, seeded
     random weights), B=8 rows of a seeded 128-token prompt, 128 new
     tokens: counts zeroed just before and read just after the call —
     the prefill's norms, 12 FA2 forwards and one kv_write, 12 decode
     launches a step each with its append, 23 norms with their add and
     2 alone a step, and nothing else — and every plain version wrapped
     to count its calls (none may run); prefill ms (the TTFT), decode
     tokens/s, one profiled decode step's busy and idle share, peak
     memory; the prefill's and first decode step's logits against the
     plain path (5e-2 x max |logit|; MoE's plain path handed the kernel
     path's expert choices); in f32 gpt2-124m's greedy tokens equal to
     ServingEngine's on the same 8 prompts (32 tokens) and cached equal
     to uncached over 8;  b. phase 4's config 6 steps straight (phase
     4's first 6 losses bit for bit), then 3 steps + save + a fresh
     model and engine loaded + 3 steps under SingleDevice and under
     Zero3 at world 1 (NCCL), each bit for bit the straight run (losses,
     params, moments, step): save and load seconds and bytes, in a temp
     dir under build/chip_smoke/ that the phase removes;
 12. the in-step collective schedule (inside phase 7c's NCCL group, every
     count zeroed before each path and read after; every number beside
     the card's name and power limit): a. through the engines at world
     1 — DDP `grad_buckets=4`, Zero3 `gather_prefetch=2` and Zero3
     `gather_prefetch=2, grad_buckets=4` under the fp8 gather, 3 steps
     of phase 4's config each: JAX's inert warning for every slot, the
     plain lowering, losses and params bit for bit SingleDevice's (phase
     4's first 3 losses; fp8: phase 8c's); b. the executors built
     directly over the one-rank group (the engines keep JAX's inert
     rule): one forward and backward of phase 4's batch through the
     prefetching gather at K=2 and K=3, the composed schedule under
     Zero3 with 4 buckets, and the bucketed release at K=4 and K=12
     under DDP — gradients bit for bit the on-demand path's (the
     bucketed tail: the plain tail through the compute dtype, JAX's
     pmean); the peak bytes of gathered layer weights against K layers'
     worth (14.18 MB a gpt2-124m layer in bf16); one profiled pass's
     share of the collectives' device time on the side streams that
     overlaps compute kernels; the pass's ms beside the on-demand
     pass's (reported, not claimed); c. from the layout: hpZ's per-rank
     replica bytes for gpt2-1.5b at data 8 over 2 granules and the
     gather wire a step with and without hpZ;
 13. the grad-comm codecs (inside the same NCCL group; every count
     zeroed before each path and read after): a. DDP `grad_comm="int8"`,
     Zero2 `grad_comm="fp8", grad_buckets=4` and Zero3 `grad_comm="int8",
     grad_comm_tail="int8"` at world 1, 3 steps of phase 4's config each:
     JAX's inert warning, the plain lowering, bit for bit SingleDevice,
     the quantizer (#10) launched no time; b. the codec functions over
     the one-rank group on one phase-4 gpt2-124m gradient (163,109,376
     f32 elements): `quantized_grad_sync` int8 (dither, error feedback)
     and fp8 bit for bit the same call on the plain quantizer, the new
     residual exactly err - dequant, 2 launches of #10 a sync; the hpZ
     rebuild codec (int8, fp8) on the rank's bf16 block shards, 1 launch,
     equal to the plain version; #10 at the codec's shape (block 256,
     dither) against its bound and in turns with its plain version, one
     whole sync's device and host ms; c. the executors at world 1:
     DDP's bucketed release (int8, K=4, the tail through the codec) and
     Zero3's composed schedule (int8, K=4, `grad_comm_tail` int8) —
     gradients and residual row bit for bit the plain quantizer's pass,
     the row `residual_len` long, 10 launches of #10 a pass;
 14. Ulysses and the counter-based dropout kernel (after 13, in the same
     NCCL group): a. `ulysses_fwd` / `ulysses_bwd` over 2 and 4 lockstep
     threads on the FA2 kernels #4-#6, gpt2-124m's (Hq = KVH = 12) and
     llama-160m's grouped (Hq 12, KVH 4: K/V at kv_heads) attention at
     B=8 T=1024 bf16, forward and backward of sum(o^2), within 2e-2 x
     max|ref| of the whole-sequence kernels, #4-#6 exactly n launches
     each, no plain version, each all-to-all's bytes against the
     expanded route's; b. `ulysses_attention` over the one-rank NCCL
     group bit for bit the direct kernel call; c. DDP, Zero2 and Zero3 at
     world 1 with seq_impl="ulysses" and dropout 0.1 on phase 4's config,
     3 steps bit for bit SingleDevice with dropout, the dropout kernel's
     launches exact (`dropout_launches_per_step`; phase 5's too);
     d. the dropout kernel (ops/dropout.py) at 8 x 1024 x 768 bf16 and
     f32 bit for bit its plain version, the whole mask = 4 row blocks
     = 2 token blocks at their offsets, timed and in turns against the
     parent's rand + where and F.dropout, host ms a call, bound in bytes;
 15. the telemetry knob and the optimizer-state offload (after 14, in
     the same NCCL group): a. Zero3 at world 1 on gpt2-1.5b (phase 8d's
     configuration, AdamW(fused=True)) with offload off, W=1 and W=2 in
     turn from one seed, 3 steps each: params and moments bit for bit
     the off arm, the moments pinned host tensors, #13 once a leaf a
     step; resting device bytes after a step, peak, step ms, and one
     profiled step's host<->device copies on the side streams; b. phase
     4's configuration with telemetry off, on and layers, 10 steps each
     in turns: losses bit for bit across the arms, the health's loss the
     step's, the norms within 1e-4 of an f64 recomputation on the same
     tensors, the launches unchanged, step ms, host ms and the device
     records a step per arm, and an inf placed in layer 5 named by
     `first_nonfinite_layer`; c. dropout through 13c's directly built
     executors (DDP's bucketed release, Zero3's composed schedule, K=4):
     loss and gradients bit for bit the plain path's under the rank-0
     folded key;
  then the `kernels` JSON line (31 rows: the 22 kernels, rows 10kv, 1r
  and the decode append, the Triton LayerNorm forward pair and the v1
  writer, launched on no path, the four RMS rows and the dropout
  kernel; launches by path, the Llama paths `llama_*`, the MoE paths
  `moe_*` and the generate paths `gen`, `L-gen`, `M-gen`, phase 12's
  `sched_*` / `exec_*`, phase 13's `codec_*`, phase 14's
  `ulysses*` / `uly_drop_*` and phase 15's `offload_*`, `telem_*` and
  `drop_exec_*` among them; row 10 timed at the grad
  codec's shape, its earlier shapes beside it), then the result line
  {"ok": true, "device": {"platform": "gpu", ...}}.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types
import warnings

# H100 SXM published peaks (dense) by operand type, the bound's
# denominators
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_LAP = [time.perf_counter()]


def lap(what):
    """Print the seconds since the previous lap: where the script's time
    goes."""
    now = time.perf_counter()
    print(f"  [{what}: {now - _LAP[0]:.2f}s]")
    _LAP[0] = now


def bound_ms(nbytes, flops, kind):
    """The least time for the work: bytes over HBM, or operations over
    the peak for the operands' type (`kind`), whichever is larger."""
    tb, tf = nbytes / HBM_BPS, flops / PEAK_FLOPS[kind]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean device time per call over `iters` back-to-back calls (CUDA
    events around the run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(torch, fn, cpu=False, tries=3):
    """Run fn under torch.profiler and return the profile, or None when
    `tries` passes all recorded no device activity (the CUPTI trace
    comes back empty now and then; a retry sees it again)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        if any(getattr(e, "device_type", None) == cuda
               and _self_device_us(e) > 0 for e in prof.key_averages()):
            return prof
    return None


class Ms(float):
    """A time in ms that carries the clock it was read on: "profiler"
    (CUPTI kernel records) or "events" (CUDA events behind a sleep)."""

    def __new__(cls, value, source):
        ms = super().__new__(cls, value)
        ms.source = source
        return ms


def _device_records(torch, prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda]


def device_ms(torch, fn, iters=20, warmup=3):
    """Mean DEVICE time per call: every kernel the call launches, summed
    from the profiler's CUDA activity over `iters` calls.  Unlike
    `time_ms` it excludes host launch overhead, which dominates at decode
    shapes.  The CUPTI trace now and then comes back empty or drops
    kernel records (a sum 2.5-5x too low, PERF.md §6): the device
    records of one clean call are counted first (the most of two one-call
    traces), a trace of `iters` calls with fewer than `iters` times that
    is taken again, and after three such traces CUDA events around the
    calls queued behind a sleep kernel stand in.  The result is an `Ms`
    that names its clock."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    per = 0
    for _ in range(2):
        prof = profiled(torch, fn, tries=2)
        if prof is not None:
            per = max(per, sum(e.count for e in _device_records(torch, prof)))
    for _ in range(3 if per else 0):
        prof = profiled(torch, run, tries=5)
        if prof is None:
            break
        evs = _device_records(torch, prof)
        if sum(e.count for e in evs) >= iters * per:
            return Ms(sum(_self_device_us(e) for e in evs) / 1e3 / iters,
                      "profiler")
    ms = _queued_ms(torch, fn, iters)
    print(f"  (the profiler's trace was empty or short of the "
          f"{iters} x {per} device records: {ms:.5g} ms from CUDA events "
          "behind a sleep)")
    return Ms(ms, "events")


def clock_of(res):
    """{timed key: the clock its `Ms` was read on} of a result row."""
    return {k: getattr(res[k], "source", None)
            for k in ("ms", "plain_ms", "library_ms")
            if res.get(k) is not None}


def _self_device_us(e):
    us = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0.0) if us is None else us


def timings(torch, kernel, plain, library):
    """Device time of the kernel, its plain version and the library call,
    plus the kernel's per-call time with launch overhead (CUDA events)."""
    return dict(ms=device_ms(torch, kernel),
                plain_ms=device_ms(torch, plain),
                library_ms=device_ms(torch, library),
                call_ms=time_ms(torch, kernel))


def _queued_ms(torch, fn, n):
    """Device time per call of n back-to-back calls queued behind a
    sleep kernel, so the host's launch cost stays off the clock."""
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def sides_in_turns(torch, fns, reps=5, n=20):
    """Device ms per call of each of `fns` (name -> fn) in turns: the
    names in order, then reversed (kernel, parent, library, library,
    parent, kernel) x reps, each n calls queued behind a sleep (CUDA
    events): {name: (median, min, max)}."""
    for _ in range(3):
        for fn in fns.values():
            fn()
    order, got = list(fns), {k: [] for k in fns}
    for _ in range(reps):
        for k in order + order[::-1]:
            got[k].append(_queued_ms(torch, fns[k], n))
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


def turns(torch, kernel, library, reps=5, n=20):
    """Kernel and library timed in turns (kernel, library, library,
    kernel) over `reps` repeats: medians, min-max spreads and the ratio,
    which cancels what the card's clock does between calls."""
    t = sides_in_turns(torch, {"kernel": kernel, "library": library}, reps,
                       n)
    (km, *ks), (lm, *ls) = t["kernel"], t["library"]
    return dict(turns_ms=km, turns_spread_ms=ks, library_turns_ms=lm,
                library_turns_spread_ms=ls, ratio=km / lm)


def call_turns(torch, kernel, unfused, reps=5, n=50):
    """Host-bound time per call (`time_ms` of n back-to-back calls: at
    decode shapes the host's enqueue sets it) of the kernel and of the
    unfused sequence in turns (kernel, unfused, unfused, kernel) x reps:
    medians and spreads, as the host drifts over a call."""
    ks, us = [], []
    for _ in range(reps):
        ks.append(time_ms(torch, kernel, n, 2))
        us.append(time_ms(torch, unfused, n, 2))
        us.append(time_ms(torch, unfused, n, 2))
        ks.append(time_ms(torch, kernel, n, 2))
    return dict(call_ms=statistics.median(ks),
                call_spread_ms=[min(ks), max(ks)],
                unfused_call_ms=statistics.median(us),
                unfused_call_spread_ms=[min(us), max(us)])


TIMED_MS = ("ms", "plain_ms", "library_ms", "call_ms", "bound_ms")
TURN_KEYS = ("turns_ms", "turns_spread_ms", "library_turns_ms",
             "library_turns_spread_ms", "ratio")
# rows 10kv and 1r: the unfused launch sequence each replaces, timed
# (device, and host per call) and in turns with the kernel
UNFUSED_KEYS = ("unfused_ms", "unfused_call_ms", "unfused_turns_ms",
                "unfused_turns_spread_ms", "call_spread_ms",
                "unfused_call_spread_ms")


def turns_text(res):
    return (f"turns: kernel {res['turns_ms']:.5g} ms "
            f"[{res['turns_spread_ms'][0]:.5g}, {res['turns_spread_ms'][1]:.5g}]"
            f", library {res['library_turns_ms']:.5g} "
            f"[{res['library_turns_spread_ms'][0]:.5g}, "
            f"{res['library_turns_spread_ms'][1]:.5g}], ratio "
            f"{res['ratio']:.4g}")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@contextlib.contextmanager
def swapped(*changes):
    """Each (module, name, value) set for the block, restored after."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in changes]
    try:
        for m, n, v in changes:
            setattr(m, n, v)
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


# -- phase 1: the build ---------------------------------------------------

# the tensor-core FA2 kernels, and the query of the dynamic shared memory
# each launches with: {kernel: (library, C query)}
TC_KERNELS = {"flash_fwd_wgmma": ("flash_fwd", "flash_fwd_smem_bytes"),
              "flash_dkv_wgmma": ("flash_bwd", "flash_dkv_smem_bytes"),
              "flash_dq_wgmma": ("flash_bwd", "flash_dq_smem_bytes")}


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        got = out.stdout.splitlines()
        if out.returncode == 0 and len(got) == len(names):
            return got
    except OSError:
        pass
    return list(names)


def kernel_resources(logs):
    """ptxas' per-kernel report (-Xptxas=-v) -> [(source, kernel,
    registers, spill stores, spill loads, static smem)]."""
    rows = []
    for src, log in logs.items():
        cur = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                cur = [src, m.group(1), 0, 0, 0, 0]
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur:
                cur[3], cur[4] = int(m.group(1)), int(m.group(2))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                cur[2] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur[5] = int(sm.group(1)) if sm else 0
                rows.append(tuple(cur))
                cur = None
    names = _demangle([r[1] for r in rows])
    return [(r[0], n, *r[2:]) for r, n in zip(rows, names)]


def hgmma_counts(lib_paths):
    """{demangled kernel: HGMMA instructions in its SASS} of the given
    libraries (`cuobjdump -sass`)."""
    from tiny_deepspeed_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    # one cuobjdump per library, all started together
    procs = [(path, subprocess.Popen([tool, "-sass", str(path)],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
             for path in lib_paths]
    for path, proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"cuobjdump -sass {path} failed: "
              f"{stderr[-500:]}")
        fn = None
        for line in stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn and "HGMMA" in line:
                counts[fn] += 1
    names = list(counts)
    return dict(zip(_demangle(names), (counts[n] for n in names)))


def build_report(_build):
    """Print each CUDA kernel's registers, spills and shared memory, and
    fail unless every bf16/f16 tensor-core FA2 instantiation and every
    bf16/f16 forward, dx and dW instantiation of the fused head issues
    HGMMA and no f32 one does (f32 keeps the FMA FA2 kernels and the
    3xTF32 wmma forward, dx and dW)."""
    resources = kernel_resources(_build.build_logs)
    for src, name, regs, sst, sld, smem in resources:
        if "ln_bwd_" in name or "ln_fwd_" in name:  # summed up below
            continue
        print(f"  ptxas {src}: {name}: {regs} registers, spill stores "
              f"{sst} B / loads {sld} B, smem {smem} B static")
    for kname, (lib, query) in TC_KERNELS.items():
        fn = _build.entry(lib, query, [ctypes.c_int])
        print(f"  {kname}: dynamic smem " + ", ".join(
            f"D={d} {fn(d)} B" for d in (32, 64)) + f" ({lib}.cu {query})")
    for kname, query in (("xent_fwd_wgmma", "fused_xent_fwd_smem_bytes"),
                         ("xent_dx_wgmma", "fused_xent_dx_smem_bytes"),
                         ("xent_dw_wgmma", "fused_xent_dw_smem_bytes")):
        fn = _build.entry("fused_xent", query, [ctypes.c_int])
        print(f"  {kname}: dynamic smem " + ", ".join(
            f"D={d} {fn(d)} B" for d in (768, 1600))
            + f" (fused_xent.cu {query})")
    for src, name, regs, sst, sld, _ in resources:
        if "xent_fwd_wgmma" in name or "xent_dx_wgmma" in name:
            print(f"  {name}: {regs} registers, spills {sst} B / {sld} B")
    counts = hgmma_counts([_build._lib_path(_build.CSRC / f"{n}.cu")
                           for n in ("flash_fwd", "flash_bwd",
                                     "fused_xent", "paged_attn",
                                     "kv_write")])
    tc = {n: c for n, c in counts.items()
          if any(k in n for k in TC_KERNELS)}
    check(len(tc) == 36, f"{len(tc)} tensor-core FA2 instantiations, "
          "expected 36 (fwd, dq and dk/dv x bf16/f16 x D 32/64 x 3 "
          "variants)")
    check(sum("flash_dq_wgmma" in n for n in tc) == 12,
          "expected 12 tensor-core dq instantiations")
    xent = {n: c for n, c in counts.items()
            if any(f"xent_{p}_" in n for p in ("fwd", "dx", "dw"))}
    xent_tc = {n: c for n, c in xent.items() if "_wgmma" in n}
    for n, c in sorted({**tc, **xent_tc}.items()):
        check(c > 0, f"{n} issues no HGMMA")
        check("bfloat16" in n or "__half" in n,
              f"{n}: not a bf16/f16 tensor-core instantiation")
    for p in ("fwd", "dx", "dw"):
        k = sum(f"xent_{p}_wgmma" in n for n in xent_tc)
        check(k == 4, f"{k} tensor-core xent {p} instantiations, expected "
              "4 (bf16/f16 x operand resident or streamed)")
    fma = {n: c for n, c in counts.items() if "flash_" in n and n not in tc}
    xent_f32 = {n: c for n, c in xent.items() if n not in xent_tc}
    check(fma and all("float" in n for n in fma),
          f"FMA FA2 kernels other than f32: {sorted(fma)}")
    check(len(xent_f32) == 3 and all(
        any(f"xent_{p}_kernel<float>" in n for n in xent_f32)
        for p in ("fwd", "dx", "dw")),
          f"wmma xent kernels other than f32's three: {sorted(xent_f32)}")
    check(all(c == 0 for c in {**fma, **xent_f32}.values()),
          "an f32 FA2 or fused-head kernel issues HGMMA")
    spills = [(n, sst, sld) for _, n, _, sst, sld, _ in resources
              if ("xent_fwd_wgmma" in n or "xent_dx_wgmma" in n)
              and (sst or sld)]
    check(not spills, f"the tensor-core forward / dx spill: {spills}")
    paged = {n: c for n, c in counts.items() if "paged_" in n}
    paged_tc = {n: c for n, c in paged.items() if "paged_span_wgmma" in n}
    check(len(paged_tc) == 8, f"{len(paged_tc)} tensor-core span "
          "instantiations, expected 8 (bf16 q over bf16, int8 and e4m3 "
          "pools, f16 over f16, x D 32/64)")
    for n, c in sorted(paged_tc.items()):
        check(c > 0, f"{n} issues no HGMMA")
        check("bfloat16" in n or "__half" in n,
              f"{n}: not a bf16/f16 tensor-core instantiation")
    paged_fma = {n: c for n, c in paged.items() if n not in paged_tc}
    check(paged_fma and all(c == 0 for c in paged_fma.values()),
          "a paged decode or FMA span kernel issues HGMMA")
    paged_spills = [(n, sst, sld) for _, n, _, sst, sld, _ in resources
                    if "paged_" in n and (sst or sld)]
    check(not paged_spills, f"paged attention kernels spill: "
          f"{paged_spills}")
    lnb = [(n, regs, sst + sld) for _, n, regs, sst, sld, _ in resources
           if "ln_bwd_" in n]
    check(not any(s for *_, s in lnb), f"ln_bwd kernels spill: "
          f"{[(n, s) for n, _, s in lnb if s]}")
    path = [f"{n}: {r} registers" for n, r, _ in lnb
            if "__nv_bfloat16, 8, 3," in n or "__nv_bfloat16, 8, 7," in n
            or "cols_kernel" in n]
    print(f"  ln_bwd: {len(lnb)} kernels, no spills"
          + (f"; the training paths' (N 768 and 1600 bf16, with and "
             f"without gs, the column fold): {'; '.join(path)}" if lnb else
             " (ptxas report not in this process's build: cached)"))
    lnf = [(n, regs, sst + sld) for _, n, regs, sst, sld, _ in resources
           if "ln_fwd_" in n]
    check(not any(s for *_, s in lnf), f"ln_fwd kernels spill: "
          f"{[(n, s) for n, _, s in lnf if s]}")
    print(f"  ln_fwd: {len(lnf)} kernels, no spills"
          + (f"; the fast ones: " + "; ".join(
              f"{n[n.index('ln_fwd_') - (4 if 'add_' in n else 0):]}: {r} "
              "registers" for n, r, _ in lnf if "_row_kernel" in n)
             if lnf else " (ptxas report not in this process's build: "
             "cached)"))
    kvw = [n for n in counts if "kv_write_kernel" in n]
    kv1 = [n for n in counts if "kv_write_v1_kernel" in n]
    check(len(kvw) == 90 and len(kv1) == 15,
          f"{len(kvw)} kv_write and {len(kv1)} kv_write_v1 instantiations, "
          "expected 90 (f32/bf16/f16 sources x f32/bf16/f16/int8/e4m3 pools "
          "x Dh 32/64/128 x 1 or 4 vectors a lane group) and 15 (sources x "
          "pools)")
    kv_res = [(n, regs, sst + sld) for _, n, regs, sst, sld, _ in resources
              if "kv_write_kernel" in n or "kv_write_v1_kernel" in n]
    check(not any(s for *_, s in kv_res), f"kv_write kernels spill: "
          f"{kv_res}")
    regs = sorted(r for n, r, _ in kv_res if "v1" not in n)
    print(f"  kv_write: {len(kvw)} instantiations (sass) and the v1 kernel's "
          f"{len(kv1)}, "
          + (f"{regs[0]}-{regs[-1]} registers, no spills" if regs else
             "ptxas report not in this process's build (cached)"))
    print(f"  sass: HGMMA in all {len(paged_tc)} bf16/f16 tensor-core span "
          f"instantiations ({min(paged_tc.values())}-"
          f"{max(paged_tc.values())} each); none in the {len(paged_fma)} "
          "decode and FMA span ones (f32 among them); no paged kernel "
          "spills")
    print(f"  sass: HGMMA in all {len(tc)} bf16/f16 tensor-core FA2 "
          f"instantiations ({min(tc.values())}-{max(tc.values())} each) and "
          f"all {len(xent_tc)} bf16/f16 fused-head forward, dx and dW ones "
          f"({min(xent_tc.values())}-{max(xent_tc.values())}); {len(fma)} "
          f"FMA FA2 kernels (f32 fwd, dq and dk/dv) and {len(xent_f32)} "
          "3xTF32 fused-head kernels (f32 fwd, dx, dW) issue none")


# -- phase 2: kernel parity -------------------------------------------------

def checked_ln_fwd(torch, ln, x, w, b, fwd=None):
    """The forward (`fwd`, default layernorm_fwd: csrc/ln_fwd.cu) on the
    card against its plain version: (y, mean, rstd) and y's max abs err.
    bf16 y: the stats agree to f32 rounding, so y agrees to ~1 bf16 ulp
    (atol 2e-2, rtol 1.6e-2)."""
    y, mean, rstd = (fwd or ln.layernorm_fwd)(x, w, b)
    torch.cuda.synchronize()
    py, pmean, prstd = ln._ln_fwd_plain(x, w, b)
    torch.testing.assert_close(y.float(), py.float(), atol=2e-2,
                               rtol=1.6e-2)
    torch.testing.assert_close(mean, pmean, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(rstd, prstd, atol=1e-5, rtol=1e-4)
    return y, mean, rstd, max_err(y, py)


def three_sides(torch, kernel, parent, library):
    """The kernel, the parent's sequence and the library call in turns
    (kernel, parent, library x 5; `sides_in_turns`, `host_in_turns`):
    device and host ms per call, medians and spreads, and the ratios."""
    sides = {"kernel": kernel, "parent": parent, "library": library}
    dev, host = sides_in_turns(torch, sides), host_in_turns(torch, sides)
    return dict(
        turns_ms=dev["kernel"][0], turns_spread_ms=list(dev["kernel"][1:]),
        parent_turns_ms=dev["parent"][0],
        parent_turns_spread_ms=list(dev["parent"][1:]),
        library_turns_ms=dev["library"][0],
        library_turns_spread_ms=list(dev["library"][1:]),
        ratio_parent=dev["kernel"][0] / dev["parent"][0],
        ratio_library=dev["kernel"][0] / dev["library"][0],
        host_ms=host["kernel"][0], host_spread_ms=list(host["kernel"][1:]),
        parent_host_ms=host["parent"][0],
        parent_host_spread_ms=list(host["parent"][1:]),
        library_host_ms=host["library"][0])


def sides_text(r):
    return (f"in turns kernel {r['turns_ms']:.5g} "
            f"[{r['turns_spread_ms'][0]:.5g}, {r['turns_spread_ms'][1]:.5g}]"
            f", parent {r['parent_turns_ms']:.5g} "
            f"[{r['parent_turns_spread_ms'][0]:.5g}, "
            f"{r['parent_turns_spread_ms'][1]:.5g}], library "
            f"{r['library_turns_ms']:.5g}: x{r['ratio_parent']:.4g} the "
            f"parent, x{r['ratio_library']:.4g} the library; host per call "
            f"in turns {r['host_ms']:.5g} (parent {r['parent_host_ms']:.5g}"
            f", library {r['library_host_ms']:.5g}) ms")


def parent_row(torch, res, fn, err):
    """The parent's (Triton) row at res's shape, from the same turns:
    its own device and host times, the library's beside them."""
    return dict(
        ms=device_ms(torch, fn), plain_ms=res["plain_ms"],
        library_ms=res["library_ms"], call_ms=time_ms(torch, fn),
        bound_ms=res["bound_ms"], bound_by=res["bound_by"],
        max_abs_err=err, shape=res["shape"],
        turns_ms=res["parent_turns_ms"],
        turns_spread_ms=res["parent_turns_spread_ms"],
        library_turns_ms=res["library_turns_ms"],
        library_turns_spread_ms=res["library_turns_spread_ms"],
        ratio=res["parent_turns_ms"] / res["library_turns_ms"],
        host_ms=res["parent_host_ms"],
        host_spread_ms=res["parent_host_spread_ms"],
        library_host_ms=res["library_host_ms"])


# rows 1 / 1r's shapes: serving's decode tick (8 rows), span verify (40),
# a prefill (512), training (8192) of 768, and gpt2-1.5b's 8192 of 1600
LN_SHAPES = ((8, 768), (40, 768), (512, 768), (8192, 768), (8192, 1600))
LN_TIMED = ((8, 768), (512, 768), (8192, 768), (8192, 1600))


def _ln_inputs(torch, rows, n, dtype, seed, wdtype=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r = ((torch.randn(rows, n, generator=g, device="cuda") * 2 + 0.3
             ).to(dtype) for _ in range(2))
    w, b = (torch.randn(n, generator=g, device="cuda").to(wdtype or dtype)
            for _ in range(2))
    return x, r, w, b


def layernorm_phase(torch, F, ln):
    """Row 1: the forward (`layernorm_fwd`, csrc/ln_fwd.cu) at LN_SHAPES
    in bf16, f32 and f16 (and an f32 weight under bf16 x) against its
    plain version (`checked_ln_fwd`), one launch a call, two calls bit
    for bit, and against the Triton kernel it replaced (`_ln_fwd_triton`,
    the parent's arm, off every path: held to the plain version too, and
    whether the two agree bit for bit printed a shape).  Then at LN_TIMED
    in bf16, in turns (`three_sides`): the kernel, the Triton kernel and
    F.layer_norm, device and host ms a call; and each one's device time
    (profiler) beside the plain version's and the bound."""
    bits, worst, worst_tri = {}, 0.0, 0.0
    for dtype, wdtype in ((torch.bfloat16, None), (torch.float32, None),
                          (torch.float16, None),
                          (torch.bfloat16, torch.float32)):
        for rows, n in LN_SHAPES:
            x, _, w, b = _ln_inputs(torch, rows, n, dtype, rows + n, wdtype)
            before = ln.layernorm_fwd.launches
            got = checked_ln_fwd(torch, ln, x, w, b)
            check(ln.layernorm_fwd.launches == before + 1,
                  "layernorm_fwd: not one launch")
            _bitwise(torch, lambda: ln.layernorm_fwd(x, w, b),
                     f"layernorm_fwd {rows}x{n}")
            tri = checked_ln_fwd(torch, ln, x, w, b, lambda *a:
                                 ln._ln_fwd_triton(*a, 1e-5))
            worst, worst_tri = max(worst, got[3]), max(worst_tri, tri[3])
            name = f"{rows}x{n} {str(dtype)[6:]}" + (
                f" (w {str(wdtype)[6:]})" if wdtype else "")
            bits[name] = all(torch.equal(u, v) for u, v in zip(got[:3],
                                                              tri[:3]))
    print(f"kernel layernorm_fwd (row 1, csrc/ln_fwd.cu): y max_abs_err="
          f"{worst:.3g} against the plain version (tol atol=2e-2 rtol="
          f"1.6e-2), one launch a call, repeatable; the Triton kernel it "
          f"replaced {worst_tri:.3g}; bit-identical to the Triton kernel "
          f"(y, mean, rstd): {bits}")
    res, tri_res = {}, {}
    for rows, n in LN_TIMED:
        x, _, w, b = _ln_inputs(torch, rows, n, torch.bfloat16, rows + n + 1)
        *_, err = checked_ln_fwd(torch, ln, x, w, b)
        *_, terr = checked_ln_fwd(torch, ln, x, w, b, lambda *a:
                                  ln._ln_fwd_triton(*a, 1e-5))
        nbytes = rows * n * 2 * 2 + 2 * n * 2 + rows * 8
        bms, by = bound_ms(nbytes, 8 * rows * n, "bfloat16")

        def kernel():
            return ln.layernorm_fwd(x, w, b)

        def parent():  # the parent's `layernorm_fwd`: dispatch, then Triton
            return ln.on_cuda(x, w, b) and ln._ln_fwd_triton(x, w, b, 1e-5)

        r = dict(**timings(torch, kernel, lambda: ln._ln_fwd_plain(x, w, b),
                           lambda: F.layer_norm(x, (n,), w, b)),
                 **three_sides(torch, kernel, parent,
                               lambda: F.layer_norm(x, (n,), w, b)),
                 bound_ms=bms, bound_by=by, max_abs_err=err,
                 shape=f"{rows}x{n} bf16")
        res[rows, n] = r
        tri_res[rows, n] = parent_row(torch, r, parent, terr)
        print(f"kernel layernorm_fwd rows={rows} N={n} bf16: "
              + " ".join(f"{k}={r[k]:.5g}" for k in
                         ("ms", "plain_ms", "library_ms", "call_ms",
                          "bound_ms"))
              + f" (Triton {tri_res[rows, n]['ms']:.5g}); " + sides_text(r))
    return res, tri_res, worst, worst_tri


def checked_fa2_fwd(torch, fa, q, k, v):
    """fa2_flash_attention_fwd on the card against its plain version:
    (o, lse) and o's max abs err.  Both round probabilities to bf16
    before PV, the plain version after normalising, the kernel before
    (o = sum(p v) / l): outputs agree to a few bf16 ulps (atol = rtol =
    2e-2; lse atol 2e-3, rtol 1e-4)."""
    o, lse = fa.fa2_flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    po, plse = fa._fa2_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)
    check(torch.isfinite(o).all().item(), "flash output not finite")
    return o, lse, max_err(o, po)


def flash_phase(torch, F, fa):
    """Serving's prefill shapes (B=1) and training's (B=8, T=1024)."""
    res, worst = {}, 0.0
    h, d = 12, 64
    for b, t in ((1, 64), (1, 512), (1, 1024), (8, 1024)):
        g = torch.Generator(device="cuda").manual_seed(t + b - 1)
        q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda"
                               ).bfloat16() for _ in range(3))
        *_, err = checked_fa2_fwd(torch, fa, q, k, v)
        worst = max(worst, err)
        nbytes = b * (4 * h * t * d * 2 + h * t * 4)
        flops = b * 4 * h * d * t * (t + 1) / 2
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        kernel = lambda: fa.fa2_flash_attention_fwd(q, k, v)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True)
        res[b, t] = dict(
            **timings(torch, kernel, lambda: fa._fa2_fwd_plain(q, k, v),
                      library),
            bound_ms=bms, bound_by=by, max_abs_err=err,
            shape=f"B={b} H={h} T={t} Dh={d} bf16")
        if t == 1024:
            res[b, t].update(turns(torch, kernel, library))
        print(f"kernel fa2_flash_attention_fwd B={b} H={h} T={t} Dh={d} "
              f"bf16: max_abs_err={err:.3g} (tol atol=rtol=2e-2; lse 2e-3) "
              + " ".join(f"{k}={v:.5g}" for k, v in res[b, t].items()
                         if k.endswith("ms") and k in TIMED_MS)
              + ("; " + turns_text(res[b, t]) if t == 1024 else ""))
    return {"serving": res[1, 1024], "training": res[8, 1024]}, worst


def _decode_case(torch, F, pa, pool_mod, pos, w, seed):
    """9a over a bf16 pool: S=8, Hq=12, Dh=64, bt=16, 12 layers, `w`
    table entries, positions `pos` — parity against the plain version at
    three layers (atol = rtol = 2e-2), times beside the bound, the plain
    version and gather + SDPA, and the kernel timed in turns with that
    library call, both rotating the layer."""
    s, hq, d, bt, nl = 8, 12, 64, 16, 12
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    nb = s * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp, vp = (torch.randn(nb + 1, bt, nl, hq, d, generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    perm = torch.randperm(nb, generator=g, device="cuda") + 1
    tables = perm.reshape(s, w).to(torch.int32)
    q = torch.randn(s, hq, 1, d, generator=g, device="cuda").bfloat16()
    view = pool_mod.KVPoolView(kp, vp)
    page = pool_mod.page_ref(tables, pos, bt)
    worst = 0.0
    for layer in (0, 5, 11):
        o = pa.paged_attention(q, view, page, layer)
        torch.cuda.synchronize()
        po = pa._paged_attention_plain(q, view, page, layer)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2,
                                   rtol=2e-2)
        worst = max(worst, max_err(o, po))
    live = int((pos.long() + 1).sum())
    nbytes = live * hq * d * 2 * 2 + 2 * s * hq * d * 2 + s * (w + 1) * 4
    bms, by = bound_ms(nbytes, 4 * live * hq * d, "bfloat16")
    # rotate the layer so each call reads other pool bytes (one layer's
    # live K/V is ~24 MB at pos <= 1000; 12 layers overflow the 50 MB L2
    # as decode does)
    nxt = _layer_cycle(nl)
    mask = (torch.arange(w * bt, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]

    def kernel():
        return pa.paged_attention(q, view, page, nxt())

    def library():
        ck, cv = pool_mod.paged_panel(view, nxt(), page)
        return F.scaled_dot_product_attention(q, ck, cv, attn_mask=mask)

    res = dict(
        **timings(torch, kernel,
                  lambda: pa._paged_attention_plain(q, view, page, nxt()),
                  library),
        bound_ms=bms, bound_by=by, max_abs_err=worst,
        shape=f"S={s} Hq={hq} Dh={d} bt={bt} W={w} "
              f"pos<={int(pos.max())} bf16")
    res.update(turns(torch, kernel, library))
    print(f"kernel paged_attention S={s} Hq={hq} Dh={d} bt={bt} W={w} "
          f"pos={pos.tolist()} bf16: max_abs_err={worst:.3g} "
          "(tol atol=rtol=2e-2); library = paged_panel + SDPA; "
          + " ".join(f"{k}={v:.5g}" for k, v in res.items()
                     if k in TIMED_MS) + "; " + turns_text(res))
    return res, worst


def paged_phase(torch, F, pa, pool_mod):
    """9a at the decode shape (pos up to 1000, W = 64) and at a long
    context (pos up to 4000, W = 256: a ~1.2 GB pool), where the serial
    walk over the table was worst."""
    res, worst = _decode_case(torch, F, pa, pool_mod,
                              [1000, 3, 15, 16, 517, 999, 0, 250], 64, 7)
    long_res, long_worst = _decode_case(
        torch, F, pa, pool_mod, [4000, 3, 1023, 1024, 2047, 3999, 0, 2500],
        256, 8)
    torch.cuda.empty_cache()
    return {"decode": res, "long_context": long_res}, max(worst,
                                                          long_worst)


def _decode_inputs(torch, pool_mod, quant_mode=None, seed=7):
    """Phase 2's decode shape — S=8, Hq=12, Dh=64, bt=16, 12 layers, 64
    table entries, pos up to 1000 — over a bf16 pool or, quantized
    through the codec, an int8 / fp8 one."""
    s, hq, d, bt, nl, w = 8, 12, 64, 16, 12, 64
    pos = torch.tensor([1000, 3, 15, 16, 517, 999, 0, 250],
                       dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (s * w + 1, bt, nl, hq, d)
    kv = [torch.randn(shape, generator=g, device="cuda").bfloat16()
          for _ in range(2)]
    if quant_mode is None:
        view = pool_mod.KVPoolView(*kv)
    else:
        (qk, sk), (qv, sv) = (pool_mod._quant_vectors(a, quant_mode)
                              for a in kv)
        view = pool_mod.KVPoolView(qk, qv, sk, sv)
    del kv
    perm = torch.randperm(s * w, generator=g, device="cuda") + 1
    tables = perm.reshape(s, w).to(torch.int32)
    return view, tables, pos, g


def _layer_cycle(nl):
    """Rotate the layer so each timed call reads other pool bytes (one
    layer's live K/V overflows nothing; 12 layers overflow the 50 MB L2
    as serving does)."""
    it = {"l": 0}

    def nxt():
        it["l"] = (it["l"] + 1) % nl
        return it["l"]
    return nxt


def _vector_bytes(view):
    """Bytes of one resting head vector per side, its scale included."""
    d = view.k.shape[-1]
    return d * view.k.element_size() + (4 if view.k_scale is not None
                                        else 0)


def paged_quant_phase(torch, F, pa, pool_mod):
    """9b: decode over int8 and fp8 pools at the decode shape, bf16 q,
    against the plain version (dequant to bf16, then attention): atol =
    rtol = 2e-2.  Library: gather + dequant (`paged_panel`) + SDPA."""
    res, worst = {}, 0.0
    for mode in ("int8", "fp8"):
        view, tables, pos, g = _decode_inputs(torch, pool_mod, mode)
        s, hq, d, nl = 8, 12, 64, 12
        page = pool_mod.page_ref(tables, pos, 16)
        q = torch.randn(s, hq, 1, d, generator=g, device="cuda").bfloat16()
        for layer in (0, 5, 11):
            o = pa.paged_attention(q, view, page, layer)
            torch.cuda.synchronize()
            po = pa._paged_attention_plain(q, view, page, layer)
            torch.testing.assert_close(o.float(), po.float(), atol=2e-2,
                                       rtol=2e-2)
            worst = max(worst, max_err(o, po))
        live = int((pos.long() + 1).sum())
        nbytes = (live * hq * _vector_bytes(view) * 2 + 2 * s * hq * d * 2
                  + s * (tables.shape[1] + 1) * 4)
        bms, by = bound_ms(nbytes, 4 * live * hq * d, "bfloat16")
        nxt = _layer_cycle(nl)
        mask = (torch.arange(tables.shape[1] * 16, device="cuda")[None, :]
                <= pos[:, None].long())[:, None, None, :]

        def library():
            ck, cv = pool_mod.paged_panel(view, nxt(), page, torch.bfloat16)
            return F.scaled_dot_product_attention(q, ck, cv, attn_mask=mask)

        def kernel():
            return pa.paged_attention(q, view, page, nxt())

        res[mode] = dict(
            **timings(torch, kernel,
                      lambda: pa._paged_attention_plain(q, view, page,
                                                        nxt()),
                      library),
            bound_ms=bms, bound_by=by, max_abs_err=worst,
            shape=f"S={s} Hq={hq} Dh={d} bt=16 pos<=1000 bf16 q, {mode} "
                  "pool")
        res[mode].update(turns(torch, kernel, library))
        print(f"kernel paged_attention_quant {mode} pool S={s} Hq={hq} "
              f"Dh={d} bt=16 pos={pos.tolist()} bf16 q: max_abs_err="
              f"{worst:.3g} (tol atol=rtol=2e-2); library = paged_panel + "
              "SDPA; " + " ".join(f"{k}={v:.5g}" for k, v in
                                  res[mode].items() if k in TIMED_MS)
              + "; " + turns_text(res[mode]))
        del view
    return res, worst


def paged_span_phase(torch, F, pa, pool_mod):
    """9c: span verify at the speculative shape (S=8, K1=5, pos0 the
    decode positions, one at 0) and the suffix-prefill shape (S=2,
    K1=256, pos0 512 and 0), over bf16 and int8 pools, bf16 q: atol =
    rtol = 2e-2 against the plain version.  Library: `paged_panel` +
    SDPA with the span mask."""
    res, worst = {}, 0.0
    hq, d, nl = 12, 64, 12
    for mode in (None, "int8"):
        view, tables, pos, g = _decode_inputs(torch, pool_mod, mode,
                                              seed=11)
        for shape, k1, pos0 in (("spec", 5, pos),
                                ("suffix", 256, torch.tensor(
                                    [512, 0], dtype=torch.int32,
                                    device="cuda"))):
            s = pos0.shape[0]
            tab = tables[:s]
            page = pool_mod.page_ref(tab, pos0, 16)
            q, sk, sv = (torch.randn(s, hq, k1, d, generator=g,
                                     device="cuda").bfloat16()
                         for _ in range(3))
            for layer in (0, 11):
                o = pa.paged_attention(q, view, page, layer,
                                       span_kv=(sk, sv))
                torch.cuda.synchronize()
                po = pa._paged_attention_plain(q, view, page, layer,
                                               (sk, sv))
                torch.testing.assert_close(o.float(), po.float(),
                                           atol=2e-2, rtol=2e-2)
                check(bool(torch.isfinite(o).all()), "span output not "
                      "finite")
                worst = max(worst, max_err(o, po))
            live = int(pos0.long().sum())
            tri = s * k1 * (k1 + 1) // 2  # span (query, key) pairs
            nbytes = (live * hq * _vector_bytes(view) * 2
                      + 4 * s * hq * k1 * d * 2 + s * (tab.shape[1] + 1) * 4)
            flops = 4 * hq * d * (k1 * live + tri)
            bms, by = bound_ms(nbytes, flops, "bfloat16")
            nxt = _layer_cycle(nl)
            t = tab.shape[1] * 16
            pmask = (torch.arange(t, device="cuda")[None, None, :]
                     < pos0.long()[:, None, None]).expand(s, k1, t)
            smask = torch.ones(k1, k1, dtype=torch.bool,
                               device="cuda").tril()[None].expand(s, k1, k1)
            mask = torch.cat([pmask, smask], dim=-1)[:, None]

            def library():
                ck, cv = pool_mod.paged_panel(view, nxt(), page,
                                              torch.bfloat16)
                return F.scaled_dot_product_attention(
                    q, torch.cat([ck, sk], 2), torch.cat([cv, sv], 2),
                    attn_mask=mask)

            def kernel():
                return pa.paged_attention(q, view, page, nxt(),
                                          span_kv=(sk, sv))

            key = (mode or "bf16", shape)
            res[key] = dict(
                **timings(torch, kernel,
                          lambda: pa._paged_attention_plain(
                              q, view, page, nxt(), (sk, sv)),
                          library),
                bound_ms=bms, bound_by=by, max_abs_err=worst,
                shape=f"S={s} Hq={hq} K1={k1} Dh={d} pos0="
                      f"{pos0.tolist()} bf16 q, {mode or 'bf16'} pool")
            res[key].update(turns(torch, kernel, library))
            print(f"kernel paged_attention_span {shape} {res[key]['shape']}: "
                  f"max_abs_err={worst:.3g} (tol atol=rtol=2e-2); library "
                  "= paged_panel + SDPA with the span mask; "
                  + " ".join(f"{k}={v:.5g}" for k, v in res[key].items()
                             if k in TIMED_MS) + "; " + turns_text(res[key]))
        del view
    return res, worst


# the fused decode's bit-identity matrix: (name, q dtype, pool dtype,
# quant mode), (Hq, KVH, Dh), and (W, positions) — offsets 0 and bt - 1,
# an invalid slot (slot 1: an all-scratch table row), the table's last
# position, and (W = 64) live ranges across many splits
APPEND_POOLS = (("bf16", "bfloat16", "bfloat16", None),
                ("f16", "float16", "float16", None),
                ("f32", "float32", "float32", None),
                ("f32q_bf16", "float32", "bfloat16", None),
                ("int8", "bfloat16", "bfloat16", "int8"),
                ("e4m3", "bfloat16", "bfloat16", "fp8"))
APPEND_HEADS = ((12, 12, 64), (4, 2, 32), (2, 1, 128), (8, 2, 64))
APPEND_POS = ((6, (0, 5, 15, 16, 6 * 16 - 1, 47)),
              (64, (0, 5, 1023, 511, 64, 700)))


def _append_case(torch, pool_mod, qdt, pdt, mode, hq, kvh, d, w, pos, seed,
                 bt=16, nl=3):
    """(view, q, k, v, page) of one fused-decode case: a noisy pool of
    distinct blocks a slot, slot 1 invalid (its table row all scratch);
    q, k and v the column slices of one (S, 1, (Hq + 2 KVH) Dh) qkv
    product, as the model hands them over."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = len(pos)
    view = pool_mod.PagedKVPool(
        n_layer=nl, kv_heads=kvh, head_dim=d, num_blocks=s * w,
        block_tokens=bt, dtype=pdt, quant=mode, device="cuda").view
    for t in view:
        if t is not None:
            if t.dtype in (torch.float32, torch.bfloat16, torch.float16):
                t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
            else:
                pool_mod._raw(t).copy_(torch.randint(
                    0, 100, t.shape, generator=g, device="cuda"))
    tables = (torch.randperm(s * w, generator=g, device="cuda") + 1
              ).reshape(s, w).to(torch.int32)
    tables[1] = 0
    page = pool_mod.page_ref(tables, torch.tensor(
        pos, dtype=torch.int32, device="cuda"), bt)
    qkv = (torch.randn(s, 1, (hq + 2 * kvh) * d, generator=g, device="cuda")
           * 3).to(qdt)
    q = qkv[..., :hq * d].reshape(s, 1, hq, d).transpose(1, 2)
    k = qkv[..., hq * d:(hq + kvh) * d].reshape(s, kvh, d)
    v = qkv[..., (hq + kvh) * d:].reshape(s, kvh, d)
    return view, q, k, v, page


def append_phase(torch, pa, pool_mod):
    """9a/9b with the decode append (`paged_attention(append_kv=)`,
    csrc/paged_attn.cu APPEND): bit for bit `kv_write` (through
    `paged_append`) followed by the decode kernel — the output of every
    valid slot and the pool's bytes and scales on blocks 1.. — over bf16,
    f16, f32 (and f32 q over bf16) and int8 / e4m3 pools, Dh 32, 64 and
    128, grouped heads, the split count forced to each of 1-8, offsets 0
    and bt - 1, the table's last position; one launch a call, counted in
    `paged_attention.appends` and not in `kv_write`'s count.  Then at
    phase 2's decode shape over bf16 and int8 pools: the fused launch,
    its plain version, and in turns the two calls it replaces (device
    ms, and host ms a call)."""
    plan, cases, valid = pa.split_plan, 0, [0, 2, 3, 4, 5]
    try:
        for (_, qn, pn, mode), (hq, kvh, d), (w, pos), splits in (
                itertools.product(APPEND_POOLS, APPEND_HEADS, APPEND_POS,
                                  range(1, 9))):
            qdt, pdt = getattr(torch, qn), getattr(torch, pn)
            view, q, k, v, page = _append_case(
                torch, pool_mod, qdt, pdt, mode, hq, kvh, d, w, pos, cases)
            ref = pool_mod.KVPoolView(*(None if t is None else t.clone()
                                        for t in view))
            pa.split_plan = (lambda n=splits, **kw:
                             plan(**kw)._replace(splits=n))
            before = (pa.paged_attention.appends, pool_mod.kv_write.launches)
            o = pa.paged_attention(q, view, page, 1, append_kv=(k, v))
            torch.cuda.synchronize()
            check((pa.paged_attention.appends, pool_mod.kv_write.launches)
                  == (before[0] + 1, before[1]),
                  "paged_attention(append_kv=): not one fused launch")
            pool_mod.paged_append(ref, k, v, 1, page)
            ro = pa.paged_attention(q, ref, page, 1)
            torch.cuda.synchronize()
            what = (f"{pn} pool, {qn} q, mode {mode}, Hq {hq} KVH {kvh} Dh "
                    f"{d}, W {w}, splits {splits}")
            check(torch.equal(o[valid], ro[valid]), f"fused decode output "
                  f"differs from kv_write + paged_decode: {what}")
            bad = [i for i, (a, b) in enumerate(zip(view, ref))
                   if a is not None and not torch.equal(
                       pool_mod._raw(a)[1:], pool_mod._raw(b)[1:])]
            check(not bad, f"fused decode pool tensors {bad} differ from "
                  f"kv_write + paged_decode on blocks 1..: {what}")
            cases += 1
    finally:
        pa.split_plan = plan
    print(f"kernel paged_attention(append_kv=) (9a/9b APPEND): {cases} cases"
          f" bit-identical to kv_write + paged_decode (valid slots' output, "
          f"pool bytes and scales on blocks 1..): pools "
          f"{[p[0] for p in APPEND_POOLS]}, (Hq, KVH, Dh) {APPEND_HEADS}, "
          f"splits 1-8, W 6 and 64 with offsets 0 and bt-1 and the table's "
          f"last position; one launch a call")
    res, worst = {}, 0.0
    for mode in (None, "int8"):
        view, tables, pos, g = _decode_inputs(torch, pool_mod, mode)
        s, hq, d, nl = 8, 12, 64, 12
        page = pool_mod.page_ref(tables, pos, 16)
        qkv = torch.randn(s, 1, 3 * hq * d, generator=g,
                          device="cuda").bfloat16()
        # q contiguous (as 9a's rows time it): the call is the kernel alone
        q = qkv[..., :hq * d].reshape(s, 1, hq, d).transpose(1, 2)
        q = q.contiguous()
        k = qkv[..., hq * d:2 * hq * d].reshape(s, hq, d)
        v = qkv[..., 2 * hq * d:].reshape(s, hq, d)
        ref = pool_mod.KVPoolView(*(None if t is None else t.clone()
                                    for t in view))
        o = pa.paged_attention(q, view, page, 4, append_kv=(k, v))
        pool_mod.paged_append(ref, k, v, 4, page)
        po = pa._paged_attention_plain(q, ref, page, 4)
        torch.cuda.synchronize()
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2,
                                   rtol=2e-2)
        err = max_err(o, po)
        worst = max(worst, err)
        del ref
        live = int((pos.long() + 1).sum())
        nbytes = (live * hq * _vector_bytes(view) * 2 + 2 * s * hq * d * 2
                  + s * (tables.shape[1] + 1) * 4
                  + 2 * s * hq * (d * 2 + _vector_bytes(view)) + 16 * s)
        bms, by = bound_ms(nbytes, 4 * live * hq * d, "bfloat16")
        nxt = _layer_cycle(nl)

        def kernel():
            return pa.paged_attention(q, view, page, nxt(), append_kv=(k, v))

        def two_calls():
            layer = nxt()
            pool_mod.paged_append(view, k, v, layer, page)
            return pa.paged_attention(q, view, page, layer)

        def plain():
            return pa._paged_attention_plain(q, view, page, nxt(),
                                             append_kv=(k, v))

        def decode():  # the decode kernel alone: the prologue's cost
            return pa.paged_attention(q, view, page, nxt())

        t = sides_in_turns(torch, {"kernel": kernel, "unfused": two_calls,
                                   "decode": decode})
        key = mode or "bf16"
        res[key] = dict(
            ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
            library_ms=None, unfused_ms=device_ms(torch, two_calls),
            decode_ms=device_ms(torch, decode),
            **call_turns(torch, kernel, two_calls),
            turns_ms=t["kernel"][0], turns_spread_ms=list(t["kernel"][1:]),
            unfused_turns_ms=t["unfused"][0],
            unfused_turns_spread_ms=list(t["unfused"][1:]),
            ratio=t["kernel"][0] / t["unfused"][0],
            decode_turns_ms=t["decode"][0],
            decode_turns_spread_ms=list(t["decode"][1:]),
            bound_ms=bms, bound_by=by, max_abs_err=err,
            shape=f"S={s} Hq={hq} Dh={d} bt=16 pos<=1000 bf16 q and rows, "
                  f"{key} pool")
        print(f"kernel paged_attention(append_kv=) {res[key]['shape']}: "
              f"max_abs_err={err:.3g} against the plain version (tol "
              f"atol=rtol=2e-2); "
              + " ".join(f"{k_}={v_:.5g}" for k_, v_ in res[key].items()
                         if k_.endswith("ms") and isinstance(v_, float))
              + f"; in turns: fused {res[key]['turns_ms']:.5g} ms, "
              f"kv_write + paged_decode {res[key]['unfused_turns_ms']:.5g} "
              f"(ratio {res[key]['ratio']:.4g}), the decode kernel alone "
              f"{res[key]['decode_turns_ms']:.5g}")
        del view
    return res, worst


def quantize_phase(torch, qm):
    """10: the blockwise quantizer at the KV append shape (96 head
    vectors x 64, bf16: S=8 slots x 12 heads), the prefill shape
    (512 x 12 x 12 vectors x 64, bf16) and the grad-comm shape (gpt2-124m's
    38.6M-element lm_head leaf in f32, block 256, int8 with a uniform
    dither).  Codes and scales must be bit-identical to the plain
    version; no one PyTorch call computes the function (library null)."""
    res = {}
    for name, n, block, dtype, mode, dither in (
            ("kv_append", 96 * 64, 64, torch.bfloat16, "int8", False),
            ("kv_append_fp8", 96 * 64, 64, torch.bfloat16, "fp8", False),
            ("prefill", 512 * 12 * 12 * 64, 64, torch.bfloat16, "int8",
             False),
            ("prefill_fp8", 512 * 12 * 12 * 64, 64, torch.bfloat16, "fp8",
             False),
            ("grad_comm", 768 * 50304, 256, torch.float32, "int8", True)):
        g = torch.Generator(device="cuda").manual_seed(n + block)
        x = torch.randn(n, generator=g, device="cuda").to(dtype)
        d = ((torch.rand(n, generator=g, device="cuda") - 0.5) if dither
             else None)
        q, sc = qm.quantize_blockwise(x, mode, block, d)
        torch.cuda.synchronize()
        pq, psc = qm._quantize_plain(x, mode, block, d)
        same = (torch.equal(q.view(torch.uint8), pq.view(torch.uint8))
                and torch.equal(sc, psc))
        err = max(max_err(q, pq), max_err(sc, psc))
        ncode = int((q.view(torch.uint8) != pq.view(torch.uint8)).sum())
        check(same, f"quantize_blockwise {name}: not bit-identical to the "
              f"plain version ({ncode} codes differ, scales equal: "
              f"{torch.equal(sc, psc)})")
        nbytes = (n * x.element_size() + (4 * n if dither else 0) + n
                  + 4 * (n // block))
        bms, by = bound_ms(nbytes, 5 * n, str(dtype)[6:])
        res[name] = dict(ms=device_ms(torch, lambda: qm.quantize_blockwise(
                             x, mode, block, d)),
                         plain_ms=device_ms(torch, lambda: qm._quantize_plain(
                             x, mode, block, d)),
                         library_ms=None,
                         call_ms=time_ms(torch, lambda: qm.quantize_blockwise(
                             x, mode, block, d)),
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         shape=f"{n // block}x{block} {str(dtype)[6:]} "
                               f"{mode}{' dither' if dither else ''}")
        print(f"kernel quantize_blockwise {name} {res[name]['shape']}: "
              f"codes and scales bit-identical to the plain version "
              f"(max_abs_err={err:.3g}); "
              + " ".join(f"{k}={v:.5g}" for k, v in res[name].items()
                         if k.endswith("ms") and v is not None))
        del x, d, q, pq
    return res


# the pool geometry of phase 3's engine (gpt2-124m, block_tokens 16, 38
# blocks a request for 8 requests) and its writers' shapes: a decode
# append of 8 slots, a verify commit of 8 x K1=5, a 512-token prefill
KV_NB, KV_BT, KV_L, KV_H, KV_D = 8 * 38 + 1, 16, 12, 12, 64


def _kv_case(torch, pool_mod, writer, pool_dtype, mode, src_dtype, seed):
    """(view, kv_write args, the parent's stacked args) at `writer`'s
    main-path shape; the view a fresh noisy pool.  Rows on scratch
    (invalid slots, rejected drafts, the padding tail) as the engine makes
    them; every other destination its own.  The prefill hands over each
    layer's own (1, P, KVH, Dh) views of its qkv product, as
    `paged_scatter` does; the parent stacked the (1, KVH, P,
    Dh) views first (`_stacked_args`)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    view = pool_mod.PagedKVPool(
        n_layer=KV_L, kv_heads=KV_H, head_dim=KV_D, num_blocks=KV_NB - 1,
        block_tokens=KV_BT, dtype=pool_dtype, quant=mode,
        device="cuda").view
    for t in view:
        if t is not None:
            pool_mod._raw(t).copy_(torch.randint(0, 100, t.shape, generator=g,
                                                 device="cuda"))
    perm = torch.randperm(KV_NB - 1, generator=g, device="cuda") + 1
    d = KV_H * KV_D
    if writer == "decode":  # the column slices of the (S, 1, 3D) product
        s = 8
        qkv = (torch.randn(s, 1, 3 * d, generator=g, device="cuda")
               * 3).to(src_dtype)

        def heads1(z):
            return z.reshape(s, 1, KV_H, KV_D).transpose(1, 2)[:, :, 0]

        k, v = heads1(qkv[..., d:2 * d]), heads1(qkv[..., 2 * d:])
        tables = perm[:s * 38].reshape(s, 38).to(torch.int32)
        tables[5] = 0  # an empty slot
        pos = torch.randint(0, 600, (s,), generator=g, device="cuda",
                            dtype=torch.int32)
        page = pool_mod.page_ref(tables, pos, KV_BT)
        args = (k[None, :, None], v[None, :, None], page.blk, page.off, 7)
        return view, args, args
    if writer == "span":  # the verify commit's (L, S, KVH, K1, Dh) stacks
        s, k1 = 8, 5
        ks, vs = ((torch.randn(KV_L, s, KV_H, k1, KV_D, generator=g,
                               device="cuda") * 2).to(src_dtype)
                  for _ in range(2))
        tables = perm[:s * 38].reshape(s, 38).to(torch.int32)
        pos0 = torch.randint(0, 595, (s,), generator=g, device="cuda",
                             dtype=torch.int32)
        count = torch.randint(0, k1 + 1, (s,), generator=g, device="cuda")
        j = torch.arange(k1, device="cuda")[None, :]
        wpos = pos0.long()[:, None] + j
        blk = torch.gather(tables.long(), 1, torch.div(
            wpos, KV_BT, rounding_mode="floor"))
        blk = torch.where(j < count[:, None], blk, 0).reshape(-1)
        off = torch.where(j < count[:, None], wpos % KV_BT, 0).reshape(-1)
        args = (ks.transpose(2, 3), vs.transpose(2, 3), blk, off, 0)
        return view, args, args
    p = 512  # a prefill of 32 whole blocks, each layer's own qkv product
    qkvs = [(torch.randn(1, p, 3 * d, generator=g, device="cuda") * 2
             ).to(src_dtype) for _ in range(KV_L)]

    def heads(z):  # (1, P, D) -> (1, KVH, P, Dh), as `_block` returns it
        return z.reshape(1, p, KV_H, KV_D).transpose(1, 2)

    kh = [heads(x[..., d:2 * d]) for x in qkvs]
    vh = [heads(x[..., 2 * d:]) for x in qkvs]
    ids = perm[:p // KV_BT].clone()
    ids[-3:] = 0  # the padding tail
    args = ([x.transpose(1, 2) for x in kh], [x.transpose(1, 2) for x in vh],
            ids, None, 0)
    return view, args, _stacked_args(torch, args, kh, vh)


def _stacked_args(torch, args, kh=None, vh=None):
    """The parent's prefill operands: the (1, KVH, P, Dh) views stacked
    into (L, 1, KVH, P, Dh) tensors (`torch.stack` in `paged_prefill`),
    read as (L, 1, P, KVH, Dh); other writers' args as they are."""
    if kh is None:
        return args
    return (torch.stack(kh).transpose(2, 3), torch.stack(vh).transpose(2, 3),
            *args[2:])


def _plain_quantizer(pool_mod, qm):
    """The pool's codec as its plain PyTorch version (the card's
    reference for the Triton kernel)."""
    return swapped((pool_mod, "quantize_blockwise",
                    lambda x, mode, block=256, dither=None:
                    qm._quantize_plain(x.reshape(-1), mode, block, dither)))


def _kv_check(torch, pool_mod, qm, view, args, sargs, what):
    """kv_write on `view` (one launch) against the same write on copies
    of it by the v1 kernel (`kv_write_v1`, from the parent's stacked
    operands `sargs`), by the unfused writer on the card
    (`_kv_write_plain`: the Triton quantizer and index writes) and by the
    plain version (those index writes through the plain codec,
    `_quantize_plain`): pool bytes and scales on blocks 1.. bit for bit
    all three.  Returns the max abs err against the plain version over k,
    v and the scales, as values."""
    v1, ref, plain = (pool_mod.KVPoolView(*(None if t is None else t.clone()
                                            for t in view))
                      for _ in range(3))
    before = pool_mod.kv_write.launches, pool_mod.kv_write_v1.launches
    pool_mod.kv_write(view, *args)
    torch.cuda.synchronize()
    check(pool_mod.kv_write.launches == before[0] + 1,
          f"kv_write {what}: not one launch")
    pool_mod.kv_write_v1(v1, *sargs)
    torch.cuda.synchronize()
    check(pool_mod.kv_write_v1.launches == before[1] + 1,
          f"kv_write_v1 {what}: not one launch")
    pool_mod._kv_write_plain(ref, *sargs)
    with _plain_quantizer(pool_mod, qm):
        pool_mod._kv_write_plain(plain, *sargs)
    torch.cuda.synchronize()
    err = 0.0
    for against, other in (("v1 kernel's", v1),
                           ("unfused writer's", ref),
                           ("plain version's", plain)):
        bad = [i for i, (a, b) in enumerate(zip(view, other))
               if a is not None and not torch.equal(
                   pool_mod._raw(a)[1:], pool_mod._raw(b)[1:])]
        check(not bad, f"kv_write {what}: pool tensors {bad} (k, v, "
              f"k_scale, v_scale) differ from the {against} on blocks 1..")
    for a, b in zip(view, plain):
        if a is not None:
            err = max(err, max_err(a[1:], b[1:]))
    return err


# the writer's timed shapes: (key, writer, quant mode); phase 3 writes a
# bf16 pool, phase 6 int8 / fp8 ones
KV_TIMED = (("prefill_bf16", "prefill", None), ("prefill_int8", "prefill",
                                                "int8"),
            ("decode_bf16", "decode", None), ("decode_int8", "decode",
                                              "int8"),
            ("span_bf16", "span", None))


def kv_write_phase(torch, pool_mod, qm):
    """10kv: the pool write (csrc/kv_write.cu) at the three writers'
    main-path shapes (prefill: 512 rows x 12 layers from each layer's own
    qkv views; span commit: 8 x K1=5 rows x 12 layers; decode: 8 slots x
    12 heads x 64 of one layer, read from the qkv product's column slice
    — off the tick, which appends inside the decode launch),
    over bf16, f32, int8 and e4m3 pools.  Pool bytes and scales on blocks
    1.. must be bit-identical to the v1 kernel (`kv_write_v1`), to the
    unfused writers on the card and to the plain version (`_kv_check`),
    one launch a call.  Times at KV_TIMED: the kernel, the plain version
    (plain codec), and in turns the kernel, the v1 kernel, the unfused
    launch sequence and (prefill) the parent's whole writer, the two
    stacks then the v1 kernel (device ms); host ms a call in turns with
    the unfused sequence; the library: the two `index_put_` calls that
    store the cast rows (the bf16 decode only: no PyTorch call
    quantizes)."""
    pools = (("bf16", torch.bfloat16, None, torch.bfloat16),
             ("f32", torch.float32, None, torch.float32),
             ("int8", torch.bfloat16, "int8", torch.bfloat16),
             ("fp8", torch.bfloat16, "fp8", torch.bfloat16))
    ok, worst = [], 0.0
    for writer in ("decode", "span", "prefill"):
        for name, pdt, mode, sdt in pools:
            view, args, sargs = _kv_case(torch, pool_mod, writer, pdt, mode,
                                         sdt, seed=len(writer) + len(name))
            worst = max(worst, _kv_check(torch, pool_mod, qm, view, args,
                                         sargs,
                                         f"{writer} over a {name} pool"))
            ok.append(f"{writer}/{name}")
            del view, args, sargs
    print(f"kernel kv_write: pool bytes and scales bit-identical to the v1 "
          f"kernel (kv_write_v1), the unfused writers and the plain version "
          f"on blocks 1.. for {', '.join(ok)} (max_abs_err={worst:.3g}); "
          f"one launch a call")
    res, v1_res = {}, {}
    for key, writer, mode in KV_TIMED:
        view, args, sargs = _kv_case(torch, pool_mod, writer, torch.bfloat16,
                                     mode, torch.bfloat16, seed=3)
        err = _kv_check(torch, pool_mod, qm, view, args, sargs, key)
        worst = max(worst, err)
        ks, vs, blk, off, l0 = sargs
        lc, r1, r2, kvh, dh = ks.shape
        vec = 2 * lc * r1 * r2 * kvh
        nbytes = (vec * dh * 2 + vec * dh * (1 if mode else 2)
                  + (vec * 4 if mode else 0) + blk.numel() * 8
                  + (0 if off is None else off.numel() * 8))
        bms, by = bound_ms(nbytes, (5 if mode else 1) * vec * dh,
                           "bfloat16")

        def kernel():
            pool_mod.kv_write(view, *args)

        def v1():
            pool_mod.kv_write_v1(view, *sargs)

        def unfused():
            pool_mod._kv_write_plain(view, *sargs)

        def plain():
            with _plain_quantizer(pool_mod, qm):
                pool_mod._kv_write_plain(view, *sargs)

        sides = {"kernel": kernel, "v1": v1, "unfused": unfused}
        if writer == "prefill":
            kh = [x.transpose(1, 2) for x in args[0]]
            vh = [x.transpose(1, 2) for x in args[1]]

            def parent():  # `paged_prefill`'s stacks, then the v1 kernel
                pool_mod.kv_write_v1(view, *_stacked_args(torch, args, kh,
                                                          vh))

            sides["parent"] = parent
        library = None
        if writer == "decode" and mode is None:
            kl, vl = view.k[:, :, l0], view.v[:, :, l0]
            k2, v2 = ks[0, :, 0], vs[0, :, 0]

            def library():
                kl.index_put_((blk, off), k2)
                vl.index_put_((blk, off), v2)

        t = sides_in_turns(torch, sides)
        kt = t["kernel"]
        row = dict(
            ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
            library_ms=None if library is None else device_ms(torch,
                                                              library),
            unfused_ms=device_ms(torch, unfused),
            **call_turns(torch, kernel, unfused),
            turns_ms=kt[0], turns_spread_ms=list(kt[1:]),
            unfused_turns_ms=t["unfused"][0],
            unfused_turns_spread_ms=list(t["unfused"][1:]),
            ratio=kt[0] / t["unfused"][0],
            v1_turns_ms=t["v1"][0], v1_turns_spread_ms=list(t["v1"][1:]),
            ratio_v1=kt[0] / t["v1"][0],
            bound_ms=bms, bound_by=by, max_abs_err=err,
            shape=f"{writer} {r1 * r2} rows x {lc} layers x {kvh}x{dh} "
                  f"bf16 -> {mode or 'bf16'} pool")
        if "parent" in t:
            row.update(parent_turns_ms=t["parent"][0],
                       parent_turns_spread_ms=list(t["parent"][1:]),
                       ratio_parent=kt[0] / t["parent"][0],
                       parent_ms=device_ms(torch, sides["parent"]))
        res[key] = row
        v1_res[key] = dict(
            ms=device_ms(torch, v1), plain_ms=row["plain_ms"],
            library_ms=row["library_ms"], call_ms=time_ms(torch, v1),
            bound_ms=bms, bound_by=by, max_abs_err=err, shape=row["shape"],
            turns_ms=t["v1"][0], turns_spread_ms=list(t["v1"][1:]))
        print(f"kernel kv_write {row['shape']}: "
              + " ".join(f"{k}={v:.5g}" for k, v in row.items()
                         if k.endswith("ms") and isinstance(v, float))
              + f" (the v1 kernel {v1_res[key]['ms']:.5g}); in turns: "
              f"kernel {kt[0]:.5g} ms, v1 {t['v1'][0]:.5g} (x"
              f"{row['ratio_v1']:.4g}), unfused {t['unfused'][0]:.5g} (x"
              f"{row['ratio']:.4g})"
              + (f", the parent's stacks + v1 {t['parent'][0]:.5g} (x"
                 f"{row['ratio_parent']:.4g})" if "parent" in t else ""))
        del view, args, sargs
    return res, v1_res, worst


def checked_add_ln_fwd(torch, ln, x, r, w, b, fwd=None):
    """The residual add + forward (`fwd`, default add_layernorm_fwd:
    csrc/ln_fwd.cu) on the card against its plain version
    (`_add_ln_fwd_plain`: `x + r`, then the plain LayerNorm): s bit for
    bit, y, mean and rstd at `checked_ln_fwd`'s tolerances.  Returns
    (s, y, mean, rstd) and y's max abs err."""
    got = (fwd or ln.add_layernorm_fwd)(x, r, w, b)
    torch.cuda.synchronize()
    ps, py, pmean, prstd = ln._add_ln_fwd_plain(x, r, w, b)
    check(torch.equal(got[0], ps), "add_layernorm_fwd: s is not x + r")
    torch.testing.assert_close(got[1].float(), py.float(), atol=2e-2,
                               rtol=1.6e-2)
    torch.testing.assert_close(got[2], pmean, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[3], prstd, atol=1e-5, rtol=1e-4)
    return got, max_err(got[1], py)


def add_ln_phase(torch, F, ln):
    """1r: the residual add + LayerNorm forward (`add_layernorm_fwd`,
    csrc/ln_fwd.cu's add kernels) at LN_SHAPES in bf16, f32 and f16: s,
    y, mean, rstd against the plain version (`checked_add_ln_fwd`), one
    launch a call, bit for bit `x + r` then `layernorm_fwd`, and
    AddLayerNormFn's x, r, w, b gradients bit for bit autograd's through
    that composition; the Triton kernel it replaced (`_add_ln_fwd_triton`)
    held to the plain version, and whether the two agree bit for bit
    printed a shape.  Then at LN_TIMED in bf16, in turns
    (`three_sides`): the kernel, the Triton kernel and `x + r` then
    F.layer_norm, device and host ms a call."""
    ok, bits, worst, worst_tri = [], {}, 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for rows, n in LN_SHAPES:
            x, r, w, b = _ln_inputs(torch, rows, n, dtype, rows + n)
            g = torch.Generator(device="cuda").manual_seed(rows)
            gs, gy = (torch.randn(rows, n, generator=g, device="cuda"
                                  ).to(dtype) for _ in range(2))
            before = ln.add_layernorm_fwd.launches
            got, err = checked_add_ln_fwd(torch, ln, x, r, w, b)
            tri, terr = checked_add_ln_fwd(
                torch, ln, x, r, w, b,
                lambda *a: ln._add_ln_fwd_triton(*a, 1e-5))
            worst, worst_tri = max(worst, err), max(worst_tri, terr)
            s = x + r
            want = (s, *ln.layernorm_fwd(s, w, b))
            torch.cuda.synchronize()
            name = f"{rows}x{n} {str(dtype)[6:]}"
            check(ln.add_layernorm_fwd.launches == before + 1,
                  "add_layernorm_fwd: not one launch")
            check(all(torch.equal(a, c) for a, c in zip(got, want)),
                  f"add_layernorm {name}: (s, y, mean, rstd) not "
                  "bit-identical to x + r then layernorm_fwd")
            bits[name] = all(torch.equal(a, c) for a, c in zip(got, tri))
            outs = []
            for fused in (True, False):
                leaves = [t.clone().requires_grad_() for t in (x, r, w, b)]
                if fused:
                    fs, fy = ln.add_layernorm(*leaves)
                else:
                    fs = leaves[0] + leaves[1]
                    fy = ln.layernorm(fs, leaves[2], leaves[3])
                outs.append(torch.autograd.grad((fs, fy), leaves, (gs, gy)))
            check(all(torch.equal(a, c) for a, c in zip(*outs)),
                  f"add_layernorm {name}: gradients not bit-identical to "
                  "the composition's")
            ok.append(name)
    print(f"kernel add_layernorm_fwd (row 1r, csrc/ln_fwd.cu): y "
          f"max_abs_err={worst:.3g} against the plain version (tol "
          f"atol=2e-2 rtol=1.6e-2; s equal), one launch a call; s, y, mean, "
          f"rstd and the x, r, w, b gradients bit-identical to x + r then "
          f"layernorm_fwd at {', '.join(ok)}; the Triton kernel it replaced "
          f"{worst_tri:.3g}; bit-identical to the Triton kernel (s, y, "
          f"mean, rstd): {bits}")
    res, tri_res = {}, {}
    for rows, n in LN_TIMED:
        x, r, w, b = _ln_inputs(torch, rows, n, torch.bfloat16, rows + n + 1)
        _, err = checked_add_ln_fwd(torch, ln, x, r, w, b)
        _, terr = checked_add_ln_fwd(
            torch, ln, x, r, w, b, lambda *a: ln._add_ln_fwd_triton(*a, 1e-5))
        nbytes = 4 * rows * n * 2 + 2 * n * 2 + rows * 8
        bms, by = bound_ms(nbytes, 10 * rows * n, "bfloat16")

        def kernel():
            return ln.add_layernorm_fwd(x, r, w, b)

        def parent():  # the parent's `add_layernorm_fwd`
            return ln.on_cuda(x, r, w, b) and ln._add_ln_fwd_triton(
                x, r, w, b, 1e-5)

        def library():
            return F.layer_norm(x + r, (n,), w, b)

        rr = dict(**timings(torch, kernel,
                            lambda: ln._add_ln_fwd_plain(x, r, w, b),
                            library),
                  **three_sides(torch, kernel, parent, library),
                  bound_ms=bms, bound_by=by, max_abs_err=err,
                  shape=f"{rows}x{n} bf16")
        res[rows, n] = rr
        tri_res[rows, n] = parent_row(torch, rr, parent, terr)
        print(f"kernel add_layernorm_fwd rows={rows} N={n} bf16: "
              + " ".join(f"{k}={rr[k]:.5g}" for k in
                         ("ms", "plain_ms", "library_ms", "call_ms",
                          "bound_ms"))
              + f" (Triton {tri_res[rows, n]['ms']:.5g}); " + sides_text(rr))
    return res, tri_res, worst, worst_tri


def _rel_err(a, b):
    """max abs err of a against b, and that over max |b|."""
    err = max_err(a, b)
    return err, err / max(float(b.float().abs().max()), 1e-30)


def _bitwise(torch, fn, what):
    first, second = fn(), fn()
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(first, second)),
          f"{what}: two runs are not bit-identical")


def _ln_bwd_inputs(torch, ln, rows, n, dtype, seed):
    """x, w, b, gy, gs and the forward kernel's (held) row stats."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 0.3
         ).to(dtype)
    w, b = (torch.randn(n, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    gy, gs = (torch.randn(rows, n, generator=g, device="cuda").to(dtype)
              for _ in range(2))
    # the forward's stats feed every backward version: held to theirs first
    _, mean, rstd, _ = checked_ln_fwd(torch, ln, x, w, b)
    return x, w, b, gy, gs, mean, rstd


def parent_ln_bwd(ln):
    """The parent's LayerNorm backward, as `layernorm_bwd`'s signature
    takes it: the Triton pair (`layernorm_dx`, then `layernorm_dwdb`),
    the eager `gs + dx` of AddLayerNormFn, and the casts."""
    def bwd(gy, x, w, mean, rstd, gs=None, w_dtype=None, b_dtype=None):
        dx = ln.layernorm_dx(gy, x, w, mean, rstd)
        if gs is not None:
            dx = gs + dx
        dw, db = ln.layernorm_dwdb(gy, x, mean, rstd)
        w_dtype = w.dtype if w_dtype is None else w_dtype
        return (dx, dw.to(w_dtype),
                db.to(w_dtype if b_dtype is None else b_dtype))
    return bwd


def host_in_turns(torch, fns, reps=5, n=50):
    """Host ms per call of each of `fns`, in turns as `sides_in_turns`:
    the wall time of enqueueing n calls after a sync (the launch queue
    never fills at these counts, so the card does not set it)."""
    order, got = list(fns), {k: [] for k in fns}
    for _ in range(reps):
        for k in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fns[k]()
            got[k].append((time.perf_counter() - t0) / n * 1e3)
    torch.cuda.synchronize()
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


# row 2+3's keys beyond `timed`: the three sides in turns, host per call
PARENT_KEYS = ("turns_ms", "turns_spread_ms", "parent_turns_ms",
               "parent_turns_spread_ms", "library_turns_ms",
               "library_turns_spread_ms", "ratio_parent", "ratio_library",
               "host_ms", "host_spread_ms", "parent_host_ms",
               "parent_host_spread_ms", "library_host_ms")
# row 10kv: the v1 kernel in the same turns, and the parent's
# whole prefill writer (its stacks, then the v1 kernel)
V1_KEYS = ("v1_turns_ms", "v1_turns_spread_ms", "ratio_v1", "parent_ms",
           # the decode with its append: the decode kernel alone beside it
           "decode_ms", "decode_turns_ms", "decode_turns_spread_ms")


def ln_bwd_phase(torch, F, ln):
    """Rows 2+3: LayerNorm's backward, `layernorm_bwd` (csrc/ln_bwd.cu),
    at the training path's shape: rows = B*T = 8192, N = 768 (gpt2-124m)
    and 1600 (gpt2-1.5b, phase 8d), bf16, also f32 and f16 at 768; with
    and without gs (AddLayerNormFn).  Tolerance per output: max abs err
    <= 2e-2 x max |plain| against `_ln_bwd_plain`; two calls bit for
    bit; the gs variant's dx bit for bit `gs +` the plain call's.  Then
    the Triton pair it replaced (the public `layernorm_dx` /
    `layernorm_dwdb`, off the training paths) at 768 bf16, same
    tolerance, repeatable.  Timed in turns (kernel, parent, library x 5)
    at 768 and 1600 bf16 with and without gs: the parent's sequence
    (`parent_ln_bwd`) and F.layer_norm's autograd backward (plus
    `gs + dx` for the add variant), device and host ms per call."""
    rows, worst = 8192, {}
    for dtype, n in ((torch.bfloat16, 768), (torch.bfloat16, 1600),
                     (torch.float32, 768), (torch.float16, 768)):
        x, w, _, gy, gs, mean, rstd = _ln_bwd_inputs(torch, ln, rows, n,
                                                     dtype, n)
        name = f"{rows}x{n} {str(dtype)[6:]}"
        for g in (None, gs):
            what = f"layernorm_bwd {name}" + (" +gs" if g is not None else "")
            before = ln.layernorm_bwd.launches
            got = ln.layernorm_bwd(gy, x, w, mean, rstd, g)
            torch.cuda.synchronize()
            check(ln.layernorm_bwd.launches == before + 1,
                  f"{what}: not one launch")
            ref = ln._ln_bwd_plain(gy, x, w, mean, rstd, g)
            check(all(a.dtype == r.dtype and a.shape == r.shape
                      for a, r in zip(got, ref)), f"{what}: dtypes/shapes")
            errs = [_rel_err(a, r) for a, r in zip(got, ref)]
            check(max(r for _, r in errs) <= 2e-2,
                  f"{what} disagrees with _ln_bwd_plain: (abs, rel) of dx, "
                  f"dw, db {errs}")
            _bitwise(torch, lambda: ln.layernorm_bwd(gy, x, w, mean, rstd, g),
                     what)
            worst[what] = errs
        plain_dx = ln.layernorm_bwd(gy, x, w, mean, rstd)[0]
        check(torch.equal(ln.layernorm_bwd(gy, x, w, mean, rstd, gs)[0],
                          gs + plain_dx),
              f"layernorm_bwd {name}: the gs variant is not gs + dx")
    print("kernel layernorm_bwd (rows 2+3) against _ln_bwd_plain, max abs "
          "err (and / max|plain|) of dx, dw, db; tol 2e-2 x max|plain|; "
          "bitwise repeatable; gs variant == gs + dx bit for bit:")
    for what, errs in worst.items():
        print(f"  {what}: " + ", ".join(f"{e:.3g} ({r:.3g})" for e, r in errs))

    # the Triton pair, the parent's arm below
    x, w, b, gy, gs, mean, rstd = _ln_bwd_inputs(torch, ln, rows, 768,
                                                 torch.bfloat16, 11)
    dx = ln.layernorm_dx(gy, x, w, mean, rstd)
    dw, db = ln.layernorm_dwdb(gy, x, mean, rstd)
    torch.cuda.synchronize()
    pdx = ln._ln_dx_plain(gy, x, w, mean, rstd)
    pdw, pdb = ln._ln_dwdb_plain(gy, x, mean, rstd)
    dx_rel = _rel_err(dx, pdx)[1]
    dwdb_rel = max(_rel_err(dw, pdw)[1], _rel_err(db, pdb)[1])
    check(dx_rel <= 2e-2 and dwdb_rel <= 2e-2,
          f"the Triton pair disagrees with its plain version: dx rel "
          f"{dx_rel:.3g}, dw/db rel {dwdb_rel:.3g}")
    _bitwise(torch, lambda: [ln.layernorm_dx(gy, x, w, mean, rstd)],
             "ln_dx")
    _bitwise(torch, lambda: ln.layernorm_dwdb(gy, x, mean, rstd), "ln_dwdb")
    print(f"  the Triton pair (layernorm_dx + layernorm_dwdb, the parent's "
          f"arm): dx rel {dx_rel:.3g}, dw/db rel {dwdb_rel:.3g} of "
          f"max|plain| (tol 2e-2), bitwise repeatable")

    parent, res = parent_ln_bwd(ln), {}
    for n in (768, 1600):
        x, w, b, gy, gs, mean, rstd = _ln_bwd_inputs(torch, ln, rows, n,
                                                     torch.bfloat16, n + 1)
        xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
        yr = F.layer_norm(xr, (n,), wr, br)

        def library():
            return torch.autograd.grad(yr, (xr, wr, br), gy,
                                       retain_graph=True)

        for add in (False, True):
            g = gs if add else None

            def kernel():
                return ln.layernorm_bwd(gy, x, w, mean, rstd, g)

            def par():
                return parent(gy, x, w, mean, rstd, g)

            def lib():
                d = library()
                return (g + d[0], *d[1:]) if add else d

            got, want = kernel(), ln._ln_bwd_plain(gy, x, w, mean, rstd, g)
            err = max(max_err(a, r) for a, r in zip(got, want))
            # bytes: gy, x (and gs) read once, dx written once, w, the
            # row stats, dw and db; ~10 operations an element
            nbytes = (4 if add else 3) * rows * n * 2 + n * 2 + rows * 8 \
                + 2 * n * 2
            bms, by = bound_ms(nbytes, (11 if add else 10) * rows * n,
                               "bfloat16")
            r = dict(
                ms=device_ms(torch, kernel),
                plain_ms=device_ms(torch, lambda: ln._ln_bwd_plain(
                    gy, x, w, mean, rstd, g)),
                library_ms=device_ms(torch, lib),
                call_ms=time_ms(torch, kernel),
                **three_sides(torch, kernel, par, lib),
                bound_ms=bms, bound_by=by, max_abs_err=err,
                shape=f"{rows}x{n} bf16" + (" +gs" if add else ""))
            res[n, add] = r
            print(f"kernel layernorm_bwd rows={rows} N={n} bf16"
                  + (" +gs" if add else "") + ": "
                  + " ".join(f"{k}={r[k]:.5g}" for k in
                             ("ms", "plain_ms", "library_ms", "call_ms",
                              "bound_ms"))
                  + "; " + sides_text(r))
    # the one pass must beat the sequence it replaced
    check(res[768, False]["ratio_parent"] < 1.0,
          "layernorm_bwd is not faster than the parent's pair at 8192x768")
    return res


def flash_bwd_phase(torch, F, fa):
    """dq and dk/dv at the training path's shape, B=8 H=12 T=1024 Dh=64
    bf16, plus a ragged T=1000 parity case.  Tolerance: max abs err <=
    2e-2 x max |plain| per output."""
    h, d = 12, 64
    errs = {}
    for b, t in ((8, 1024), (2, 1000)):
        g = torch.Generator(device="cuda").manual_seed(t + b)
        q, k, v, do = (torch.randn(b, h, t, d, generator=g, device="cuda"
                                   ).bfloat16() for _ in range(4))
        # o and lse feed both backward versions: held to theirs first
        o, lse, _ = checked_fa2_fwd(torch, fa, q, k, v)
        di = (do.float() * o.float()).sum(-1)
        dq = fa.fa2_flash_attention_dq(q, k, v, do, lse, di)
        dk, dv = fa.fa2_flash_attention_dkv(q, k, v, do, lse, di)
        torch.cuda.synchronize()
        pdq = fa._fa2_dq_plain(q, k, v, do, lse, di)
        pdk, pdv = fa._fa2_dkv_plain(q, k, v, do, lse, di)
        e_kv = [_rel_err(dk, pdk), _rel_err(dv, pdv)]
        errs[t] = {"dq": _rel_err(dq, pdq),
                   "dkv": (max(e for e, _ in e_kv), max(r for _, r in e_kv))}
        check(errs[t]["dq"][1] <= 2e-2 and errs[t]["dkv"][1] <= 2e-2,
              f"flash backward T={t} disagrees with its plain version: dq "
              f"rel {errs[t]['dq'][1]:.3g}, dk/dv rel "
              f"{errs[t]['dkv'][1]:.3g}")
        _bitwise(torch, lambda: [fa.fa2_flash_attention_dq(
            q, k, v, do, lse, di)], f"dq T={t}")
        _bitwise(torch, lambda: fa.fa2_flash_attention_dkv(
            q, k, v, do, lse, di), f"dkv T={t}")
        print(f"  flash backward B={b} H={h} T={t} Dh={d} bf16: dq "
              f"max_abs_err={errs[t]['dq'][0]:.3g} ({errs[t]['dq'][1]:.3g} "
              f"of max|plain|), dk/dv max_abs_err={errs[t]['dkv'][0]:.3g} "
              f"({errs[t]['dkv'][1]:.3g}); tol 2e-2; bitwise repeatable")
        if t == 1024:
            main = (q, k, v, do, lse, di)
    q, k, v, do, lse, di = main
    b, t = 8, 1024
    # the yardstick for both passes: the backward of causal SDPA
    qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
    outr = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def library():
        return torch.autograd.grad(outr, (qr, kr, vr), do,
                                   retain_graph=True)

    lib_ms = device_ms(torch, library)
    panel = b * h * t * d * 2
    stats = 2 * b * h * t * 4
    tri = d * t * (t + 1) / 2 * b * h
    res = {}
    for name, key, kernel, plain, nbytes, flops in (
            ("fa2_flash_attention_dq", "dq",
             lambda: fa.fa2_flash_attention_dq(q, k, v, do, lse, di),
             lambda: fa._fa2_dq_plain(q, k, v, do, lse, di),
             5 * panel + stats, 6 * tri),
            ("fa2_flash_attention_dkv", "dkv",
             lambda: fa.fa2_flash_attention_dkv(q, k, v, do, lse, di),
             lambda: fa._fa2_dkv_plain(q, k, v, do, lse, di),
             6 * panel + stats, 8 * tri)):
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        res[name] = dict(ms=device_ms(torch, kernel, iters=5),
                         plain_ms=device_ms(torch, plain, iters=5),
                         library_ms=lib_ms,
                         call_ms=time_ms(torch, kernel, iters=5),
                         bound_ms=bms, bound_by=by,
                         max_abs_err=max(errs[1024][key][0],
                                         errs[1000][key][0]),
                         shape=f"B={b} H={h} T={t} Dh={d} bf16",
                         **turns(torch, kernel, library))
        print(f"kernel {name} B={b} H={h} T={t} Dh={d} bf16: max_abs_err="
              f"{res[name]['max_abs_err']:.3g} (T=1024 and T=1000; tol 2e-2 "
              "x max|plain|); library = SDPA causal backward, both passes; "
              + " ".join(f"{k}={v:.5g}" for k, v in res[name].items()
                         if k in TIMED_MS) + "; " + turns_text(res[name]))
    return res


def _profile_names(torch, fn, want):
    """Device kernel names of one profiled call of fn, retaken (up to ten
    traces, a short sleep after each that misses) until one holds a name
    containing `want`: CUPTI sometimes returns empty traces for a while,
    then recovers."""
    names = set()
    for _ in range(10):
        prof = profiled(torch, fn, tries=2)
        if prof is not None:
            names = {e.key for e in _device_records(torch, prof)}
            if any(want in n for n in names):
                break
        time.sleep(0.5)
    return names


def flash_f32_phase(torch, fa):
    """f32 reaches the FP32-FMA forward, dq and dk/dv kernels, not the
    wgmma ones: each against its plain version at the card tests' f32
    tolerance (forward atol = rtol = 1e-4, lse 2e-3 / 1e-4; dq and dk/dv
    max abs err <= 1e-4 x max |plain|) at the shapes the f32 serving path
    (phase 6) and training give them — forward B=1 T=1024 and a ragged
    prompt, T=300; dk/dv B=8 T=1024; dq B=8 T=1024 and the ragged T=300
    — and a profiled call of each names the FMA kernel and no wgmma one
    (build_report: those issue no HGMMA)."""
    h, d = 12, 64
    res = {}
    for b, t in ((1, 1024), (1, 300), (8, 1024)):
        g = torch.Generator(device="cuda").manual_seed(3 * t + b)
        q, k, v, do = (torch.randn(b, h, t, d, generator=g, device="cuda")
                       for _ in range(4))
        o, lse = fa.fa2_flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        po, plse = fa._fa2_fwd_plain(q, k, v)
        torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)
        names = _profile_names(
            torch, lambda: fa.fa2_flash_attention_fwd(q, k, v),
            "fp32::flash_fwd_kernel<float")
        check(any("fp32::flash_fwd_kernel<float" in n for n in names)
              and not any("wgmma" in n for n in names),
              f"the f32 forward B={b} T={t} did not run the FMA kernel: "
              f"{sorted(names)}")
        res["fwd", b, t] = max_err(o, po)
        msg = (f"  flash f32 B={b} H={h} T={t} Dh={d}: forward (FMA kernel) "
               f"max_abs_err={res['fwd', b, t]:.3g} (tol atol=rtol=1e-4)")
        di = (do * o).sum(-1)
        if b == 8 or t == 300:
            dq = fa.fa2_flash_attention_dq(q, k, v, do, lse, di)
            torch.cuda.synchronize()
            err, rel = _rel_err(dq, fa._fa2_dq_plain(q, k, v, do, lse, di))
            check(rel <= 1e-4, f"f32 dq B={b} T={t} disagrees with its "
                  f"plain version: rel {rel:.3g}")
            names = _profile_names(
                torch, lambda: fa.fa2_flash_attention_dq(q, k, v, do, lse,
                                                         di),
                "flash_dq_kernel<float")
            check(any("flash_dq_kernel<float" in n for n in names)
                  and not any("wgmma" in n for n in names),
                  f"the f32 dq B={b} T={t} did not run the FMA kernel: "
                  f"{sorted(names)}")
            res["dq", b, t] = err
            msg += (f"; dq (FMA kernel) max_abs_err={err:.3g} ({rel:.3g} "
                    "of max|plain|; tol 1e-4)")
        if b == 8:
            dk, dv = fa.fa2_flash_attention_dkv(q, k, v, do, lse, di)
            torch.cuda.synchronize()
            pdk, pdv = fa._fa2_dkv_plain(q, k, v, do, lse, di)
            e_kv = [_rel_err(dk, pdk), _rel_err(dv, pdv)]
            rel = max(r for _, r in e_kv)
            check(rel <= 1e-4, f"f32 dk/dv B={b} T={t} disagrees with its "
                  f"plain version: rel {rel:.3g}")
            names = _profile_names(
                torch, lambda: fa.fa2_flash_attention_dkv(q, k, v, do, lse,
                                                          di),
                "flash_dkv_kernel<float")
            check(any("flash_dkv_kernel<float" in n for n in names)
                  and not any("wgmma" in n for n in names),
                  f"the f32 dk/dv B={b} T={t} did not run the FMA kernel: "
                  f"{sorted(names)}")
            res["dkv", b, t] = max(e for e, _ in e_kv)
            msg += (f"; dk/dv (FMA kernel) max_abs_err="
                    f"{res['dkv', b, t]:.3g} ({rel:.3g} of max|plain|; tol "
                    "1e-4)")
        print(msg)
        del q, k, v, do
    torch.cuda.empty_cache()
    return {"fa2_flash_attention_fwd": max(
                v for k, v in res.items() if k[0] == "fwd"),
            "fa2_flash_attention_dq": max(
                v for k, v in res.items() if k[0] == "dq"),
            "fa2_flash_attention_dkv": res["dkv", 8, 1024]}


def xent_phase(torch, F, fx):
    """fused_xent_fwd, _dx and _dw at the knobbed training path's shape
    (S = B*T = 8192, D = 768, V = 50304, bf16) and two ragged cases: S =
    1000 with GPT-2's published V = 50257 (the padded 50304 = 128 x 393
    never exercises the vocab tail), and gpt2-1.5b's D = 1600 at S = 512.
    Tolerances: loss and lse max abs err <= 1e-3; dx and dW rel L2 err
    <= 1e-2 against the plain versions, whose dz stays f32 (the kernels
    round dz to bf16 before its product).  Each kernel runs twice and
    must agree bit for bit.  f32 takes the 3xTF32 wmma forward, dx and dW
    (profiled calls name them), held to their plain versions at lse 1e-5
    and rel L2 1e-4 at S = 1000, V = 50257 (`_xent_f32_check`).  Each row
    is also timed in turns (`turns`) with the one PyTorch call for the
    same function: `F.linear` + `F.cross_entropy` for the forward, that
    pair's autograd backward for dx alone and for dW alone; and the whole
    head (forward, dx, dW) against the pair's forward and backward."""
    errs, main = {}, None
    for s_, d, v in ((8192, 768, 50304), (1000, 768, 50257),
                     (512, 1600, 50304)):
        g = torch.Generator(device="cuda").manual_seed(s_ + d + v)
        x = torch.randn(s_, d, generator=g, device="cuda").bfloat16()
        w = (torch.randn(d, v, generator=g, device="cuda") * 0.05
             ).bfloat16()
        tg = torch.randint(0, v, (s_,), generator=g, device="cuda")
        gs = torch.full((1,), 1.0 / s_, device="cuda")
        loss, lse = fx.fused_xent_fwd(x, w, tg)
        dx = fx.fused_xent_dx(x, w, tg, lse, gs)
        dw = fx.fused_xent_dw(x, w, tg, lse, gs)
        torch.cuda.synchronize()
        ploss, plse = fx._xent_fwd_plain(x, w, tg)
        pdx = fx._xent_dx_plain(x, w, tg, plse, gs)
        pdw = fx._xent_dw_plain(x, w, tg, plse, gs)
        e = {"fwd": max(max_err(loss, ploss), max_err(lse, plse)),
             "dx": _rel_err(dx, pdx)[0], "dw": _rel_err(dw, pdw)[0],
             "dx_rel": float((dx.float() - pdx.float()).norm()
                             / pdx.float().norm()),
             "dw_rel": float((dw - pdw).norm() / pdw.norm())}
        errs[s_, d, v] = e
        print(f"  fused xent S={s_} D={d} V={v} bf16: loss/lse max_abs_err "
              f"{e['fwd']:.3g} (tol 1e-3); dx rel L2 {e['dx_rel']:.3g}, dW "
              f"rel L2 {e['dw_rel']:.3g} (tol 1e-2)")
        check(e["fwd"] <= 1e-3 and e["dx_rel"] <= 1e-2
              and e["dw_rel"] <= 1e-2,
              f"fused xent S={s_} D={d} V={v} disagrees with its plain "
              "version")
        _bitwise(torch, lambda: fx.fused_xent_fwd(x, w, tg),
                 f"fused_xent_fwd S={s_}")
        _bitwise(torch, lambda: [fx.fused_xent_dx(x, w, tg, lse, gs)],
                 f"fused_xent_dx S={s_}")
        _bitwise(torch, lambda: [fx.fused_xent_dw(x, w, tg, lse, gs)],
                 f"fused_xent_dw S={s_}")
        if main is None:
            main = (x, w, tg, lse, gs)
        del dx, dw, pdx, pdw
    _xent_f32_check(torch, fx)
    x, w, tg, lse, gs = main
    s_, d = x.shape
    v = w.shape[1]
    wt = w.t()
    # The bf16 forward and dx read w^T (V, D).  w here is (D, V), an
    # untied head's layout: the forward's row is timed with the w^T copy
    # in its call (the wrapper makes it, as FusedXentFn does once a
    # step), dx handed the copy as FusedXentFn hands it.
    wk = wt.contiguous().t()
    wt_copy_ms = device_ms(torch, wt.contiguous, iters=5)
    print(f"  fused xent: w^T copy (untied head, once a step, in the "
          f"forward's row) {float(wt_copy_ms):.5g} ms")

    def lib_fwd():
        return F.cross_entropy(F.linear(x, wt).float(), tg, reduction="none")

    # the backward yardsticks: that pair's autograd backward for dx alone
    # and for dW alone (each the softmax backward and one product)
    xr, wr = x.detach().requires_grad_(), wt.detach().requires_grad_()
    lr_ = F.cross_entropy(F.linear(xr, wr).float(), tg)

    def lib_dx():
        return torch.autograd.grad(lr_, xr, retain_graph=True)

    def lib_dw():
        return torch.autograd.grad(lr_, wr, retain_graph=True)

    op = 2 * s_ * d * v
    xb, wb = s_ * d * 2, d * v * 2
    res = {}
    for name, kernel, plain, lib, what, nbytes, flops, err in (
            ("fused_xent_fwd", lambda: fx.fused_xent_fwd(x, w, tg),
             lambda: fx._xent_fwd_plain(x, w, tg), lib_fwd,
             "F.linear + F.cross_entropy; kernel + the w^T copy",
             xb + wb + s_ * 8 + 2 * s_ * 4, op,
             max(e["fwd"] for e in errs.values())),
            ("fused_xent_dx", lambda: fx.fused_xent_dx(x, wk, tg, lse, gs),
             lambda: fx._xent_dx_plain(x, w, tg, lse, gs), lib_dx,
             "that pair's backward for dx alone",
             xb + wb + s_ * 12 + 4 + xb, 2 * op,
             max(e["dx"] for e in errs.values())),
            ("fused_xent_dw", lambda: fx.fused_xent_dw(x, w, tg, lse, gs),
             lambda: fx._xent_dw_plain(x, w, tg, lse, gs), lib_dw,
             "that pair's backward for dW alone",
             xb + wb + s_ * 12 + 4 + d * v * 4, 2 * op,
             max(e["dw"] for e in errs.values()))):
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        res[name] = dict(ms=device_ms(torch, kernel, iters=5),
                         plain_ms=device_ms(torch, plain, iters=3),
                         library_ms=device_ms(torch, lib, iters=5),
                         call_ms=time_ms(torch, kernel, iters=5),
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         shape=f"S={s_} D={d} V={v} bf16",
                         **turns(torch, kernel, lib, n=5))
        print(f"kernel {name} S={s_} D={d} V={v} bf16: max_abs_err={err:.3g} "
              f"(all three shapes); library = {what}; "
              + " ".join(f"{k}={v_:.5g}" for k, v_ in res[name].items()
                         if k in TIMED_MS) + "; " + turns_text(res[name]))
    alone = turns(torch, lambda: fx.fused_xent_fwd(x, wk, tg), lib_fwd, n=5)
    print("  fused_xent_fwd handed w^T (the kernel alone, as for a tied "
          "head): " + turns_text(alone))
    # the whole head, forward and backward, against the pair's
    xh, wh = x.detach().requires_grad_(), w.detach().requires_grad_()

    def head_fused():
        return torch.autograd.grad(fx.pallas_fused_xent(xh, wh, tg),
                                   (xh, wh))

    def head_lib():
        return torch.autograd.grad(
            F.cross_entropy(F.linear(xr, wr).float(), tg), (xr, wr))

    head = turns(torch, head_fused, head_lib, n=5)
    print(f"  fused head forward + dx + dW (FusedXentFn, untied w) vs "
          f"F.linear + F.cross_entropy forward + backward: "
          + turns_text(head))
    return res


def _xent_f32_check(torch, fx):
    """f32 forward, dx and dW on the 3xTF32 wmma kernels (a profiled call
    of each names its wmma kernel and no wgmma one) against their plain
    versions: lse max abs err <= 1e-5, dx and dW rel L2 <= 1e-4, as the
    card tests hold them."""
    s_, d, v = 1000, 768, 50257
    g = torch.Generator(device="cuda").manual_seed(s_ + d + v)
    x = torch.randn(s_, d, generator=g, device="cuda")
    w = torch.randn(d, v, generator=g, device="cuda") * 0.05
    tg = torch.randint(0, v, (s_,), generator=g, device="cuda")
    gs = torch.full((1,), 1.0 / s_, device="cuda")
    _, lse = fx.fused_xent_fwd(x, w, tg)
    _, plse = fx._xent_fwd_plain(x, w, tg)
    lse_err = max_err(lse, plse)
    rel = {}
    for name, kernel, plain in (
            ("dx", fx.fused_xent_dx, fx._xent_dx_plain),
            ("dw", fx.fused_xent_dw, fx._xent_dw_plain)):
        got, ref = kernel(x, w, tg, lse, gs), plain(x, w, tg, lse, gs)
        rel[name] = float((got - ref).norm() / ref.norm())
    for name, fn in (
            ("fwd", lambda: fx.fused_xent_fwd(x, w, tg)),
            ("dx", lambda: fx.fused_xent_dx(x, w, tg, lse, gs)),
            ("dw", lambda: fx.fused_xent_dw(x, w, tg, lse, gs))):
        want = f"xent_{name}_kernel<float"
        names = _profile_names(torch, fn, want)
        check(any(want in n for n in names)
              and not any("wgmma" in n for n in names),
              f"f32 {name} did not run the 3xTF32 kernel: {sorted(names)}")
    print(f"  fused xent f32 S={s_} D={d} V={v} (3xTF32 wmma kernels): lse "
          f"max_abs_err {lse_err:.3g} (tol 1e-5); dx rel L2 {rel['dx']:.3g}, "
          f"dW rel L2 {rel['dw']:.3g} (tol 1e-4)")
    check(lse_err <= 1e-5 and max(rel.values()) <= 1e-4,
          "the f32 fused head disagrees with its plain version")


def adamw_phase(torch, af, leaf_shapes):
    """adamw_update_fused at the lm_head leaf (768 x 50304) and at ragged
    leaves (768 and 1,000,003 elements), L2-folded and decoupled decay,
    with and without maximize.  Tolerance: max abs err <= 1e-6 x max |p|
    for p, m and v against the plain version (same f32 formula; the
    kernel's division and sqrt round otherwise).  Bitwise repeatable.
    Times at the lm_head leaf and over the 17 leaves of gpt2-124m (one
    step); the yardstick is torch.optim.Adam(fused=True,
    weight_decay=0.1) — L2-folded decay, the same arithmetic."""
    b1, b2, step = 0.9, 0.999, 3
    base = dict(lr=1e-3, c1=1 - b1 ** step, c2=1 - b2 ** step, b1=b1, b2=b2,
                eps=1e-8, wd=0.1)
    worst, worst_abs = 0.0, 0.0
    lm = leaf_shapes["lm_head.w"]
    for n in (lm[0] * lm[1], 768, 1_000_003):
        g = torch.Generator(device="cuda").manual_seed(n)
        p, gr, m = (torch.randn(n, generator=g, device="cuda")
                    for _ in range(3))
        v = torch.rand(n, generator=g, device="cuda") * 1e-2
        for dec, mx in ((False, False), (True, False), (False, True),
                        (True, True)):
            kw = dict(base, decoupled=dec, maximize=mx)
            a = [t.clone() for t in (p, gr, m, v)]
            b = [t.clone() for t in (p, gr, m, v)]
            af.adamw_update_fused(*a, **kw)
            af._adamw_update_plain(*b, **kw)
            torch.cuda.synchronize()
            scale = float(b[0].abs().max())
            err = max(max_err(a[i], b[i]) for i in (0, 2, 3))
            worst = max(worst, err / scale)
            worst_abs = max(worst_abs, err)
            check(err <= 1e-6 * scale, f"adamw n={n} decoupled={dec} "
                  f"maximize={mx}: max abs err {err:.3g} > 1e-6 x {scale}")
            c = [t.clone() for t in (p, gr, m, v)]
            af.adamw_update_fused(*c, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a[i], c[i]) for i in (0, 2, 3)),
                  f"adamw n={n}: two runs are not bit-identical")
    print(f"  adamw_update_fused n in (38633472, 768, 1000003), decoupled "
          f"x maximize: max abs err <= {worst:.3g} x max|p| (tol 1e-6); "
          "bitwise repeatable")
    # timing: the lm_head leaf, and one step over every leaf
    g = torch.Generator(device="cuda").manual_seed(1)
    leaves = {k: [torch.randn(sh, generator=g, device="cuda")
                  for _ in range(3)]
              + [torch.rand(sh, generator=g, device="cuda") * 1e-2]
              for k, sh in leaf_shapes.items()}
    kw = dict(base, decoupled=False, maximize=False)
    lp, lg, lm_, lv = leaves["lm_head.w"]
    one = lambda: af.adamw_update_fused(lp, lg, lm_, lv, **kw)  # noqa: E731

    def step_all():
        for q, gq, mq, vq in leaves.values():
            af.adamw_update_fused(q, gq, mq, vq, **kw)

    def plain_one():
        af._adamw_update_plain(lp, lg, lm_, lv, **kw)

    def torch_opt(params):
        ps = [q.detach().clone().requires_grad_() for q in params]
        for q, src in zip(ps, params):
            q.grad = src.clone()
        opt = torch.optim.Adam(ps, lr=1e-3, weight_decay=0.1, fused=True)
        return opt.step

    lib_one = torch_opt([lp])
    lib_all = torch_opt([t[0] for t in leaves.values()])
    n_all = sum(t[0].numel() for t in leaves.values())
    bms, by = bound_ms(28 * lp.numel(), 15 * lp.numel(), "float32")
    res = dict(ms=device_ms(torch, one), plain_ms=device_ms(torch, plain_one),
               library_ms=device_ms(torch, lib_one),
               call_ms=time_ms(torch, one), bound_ms=bms, bound_by=by,
               max_abs_err=worst_abs, shape=f"{lp.numel()} f32 (lm_head leaf)")
    step_b, _ = bound_ms(28 * n_all, 15 * n_all, "float32")
    res["per_step"] = dict(ms=device_ms(torch, step_all, iters=5),
                           library_ms=device_ms(torch, lib_all, iters=5),
                           call_ms=time_ms(torch, step_all, iters=5),
                           bound_ms=step_b, leaves=len(leaves),
                           params=n_all)
    print(f"kernel adamw_update_fused lm_head leaf f32: max_abs_err="
          f"{worst_abs:.3g} ({worst:.3g} of max|p|); library = "
          "torch.optim.Adam(fused=True); "
          + " ".join(f"{k}={v_:.5g}" for k, v_ in res.items()
                     if k.endswith("ms"))
          + "; one step over all " + str(len(leaves)) + " leaves ("
          + str(n_all) + " params): "
          + " ".join(f"{k}={v_:.5g}" for k, v_ in res["per_step"].items()
                     if k.endswith("ms")))
    return res


# -- phase 3: serving ------------------------------------------------------

def serving_traffic(np):
    """16 greedy requests, prompt lengths drawn from 16-512 (seed 0), and
    the 64 new tokens each asks for."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 513, size=16)
    return [rng.integers(0, 50257, size=int(n)).tolist() for n in lens], 64


def plain_prefill_logits(torch, port, model, prompt, extra=None):
    """The first request's prefill logits through every kernel's plain
    version on the card (the module-level ops the model calls swapped
    for their plain versions, and `extra`, a context that swaps more),
    next to the kernel path's."""
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    from tiny_deepspeed_tpu_torch.ops.flash_fa2 import (
        _fa2_fwd_plain, fa2_flash_attention_fwd)
    from tiny_deepspeed_tpu_torch.ops.layernorm import (_add_ln_fwd_plain,
                                                        _ln_fwd_plain)
    from tiny_deepspeed_tpu_torch.ops.paged_attn import paged_attention
    from tiny_deepspeed_tpu_torch.serving import pool as pool_mod
    from tiny_deepspeed_tpu_torch.serving.pool import PagedKVPool

    bt = 16
    p = len(prompt)
    bucket = 1 << max(0, (p - 1).bit_length())
    bucket = max(bt, bucket)
    idx = torch.zeros(1, bucket, dtype=torch.long, device="cuda")
    idx[0, :p] = torch.tensor(prompt, device="cuda")
    ids = torch.arange(1, bucket // bt + 1, device="cuda")

    def run():
        c = model.config
        pool = PagedKVPool(n_layer=c.n_layer,
                           kv_heads=getattr(c, "kv_heads", c.n_head),
                           head_dim=c.head_dim, num_blocks=bucket // bt,
                           block_tokens=bt, dtype=torch.bfloat16,
                           device="cuda")
        return model.paged_prefill(idx, p - 1, ids, pool.view, bt)[0]

    before = paged_attention.launches
    kern = run()
    fwd = fa2_flash_attention_fwd.launches
    with swapped(
            (gpt2_mod, "layernorm", lambda x, w, b, eps=1e-5:
             _ln_fwd_plain(x, w, b, eps)[0]),
            (gpt2_mod, "add_layernorm", lambda x, r, w, b, eps=1e-5:
             _add_ln_fwd_plain(x, r, w, b, eps)[:2]),
            (gpt2_mod, "sharded_attention", lambda q, k_, v, impl, pctx=None:
             _fa2_fwd_plain(q, k_, v)[0]),
            (pool_mod, "kv_write", pool_mod._kv_write_plain)), \
            extra or contextlib.nullcontext():
        plain = run()
    check(paged_attention.launches == before, "prefill ran decode kernels")
    check(fa2_flash_attention_fwd.launches == fwd,
          "the plain prefill launched the FA2 kernel")
    return kern, plain


def serve(torch, port, model, prompts, new, profile=False):
    from tiny_deepspeed_tpu_torch.serving import ServeConfig, ServingEngine
    longest = max(len(p) for p in prompts) + new
    per_req = -(-longest // 16) + 1
    cfg = ServeConfig(max_active=8, block_tokens=16,
                      num_blocks=8 * per_req, max_seq_tokens=longest)
    eng = ServingEngine(model, cfg)
    seg = {"prefill_s": 0.0, "decode_s": 0.0, "decode_ticks": 0,
           "prefills": 0}
    pre, dec = eng._prefill_step, eng._decode_plain

    def timed_prefill(*a):
        t = time.perf_counter()
        try:
            return pre(*a)  # ends in a host sync (the sampled token)
        finally:
            seg["prefill_s"] += time.perf_counter() - t
            seg["prefills"] += 1

    def timed_decode(*a):
        t = time.perf_counter()
        try:
            return dec(*a)  # ends in a host sync (the token fetch)
        finally:
            seg["decode_s"] += time.perf_counter() - t
            seg["decode_ticks"] += 1

    eng._prefill_step, eng._decode_plain = timed_prefill, timed_decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new) for p in prompts]
    if profile:  # device records only: kernel_shares reads nothing else
        prof = profiled(torch, lambda: eng.drain(max_ticks=10_000), tries=1)
    else:
        prof = None
        eng.drain(max_ticks=10_000)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, wall, seg, prof


def kernel_shares(torch, prof, patterns):
    """Device time by kernel name (and in all) from a profiled pass."""
    cuda = torch.autograd.DeviceType.CUDA
    per, busy = {}, 0.0
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != cuda:
            continue
        us = _self_device_us(e)
        busy += us
        rows.append((us, e.count, e.key))
        # the longest matching fragment: "_add_ln_fwd_kernel" also holds
        # "_ln_fwd_kernel"
        hits = [(len(pat), name) for name, pat in patterns.items()
                if pat in e.key]
        if hits:
            name = max(hits)[1]
            per[name] = per.get(name, 0.0) + us
    rows.sort(reverse=True)
    return per, busy, rows


def _add_then_norm(x, r, w, b, eps=1e-5):
    """`add_layernorm`'s composition: `x + r`, then the forward kernel
    (LayerNormFn) on the sum."""
    from tiny_deepspeed_tpu_torch.ops.layernorm import layernorm
    s = x + r
    return s, layernorm(s, w, b, eps)


def _append_apart(pool_mod, pa):
    """The model's `paged_attention` with the decode append routed as two
    calls again — `paged_append` (a `kv_write` launch) then the decode
    kernel — the parent's route."""
    def two_calls(q, view, page, l, span_kv=None, append_kv=None):
        if append_kv is not None:
            pool_mod.paged_append(view, *append_kv, l, page)
        return pa.paged_attention(q, view, page, l, span_kv=span_kv)
    return two_calls


def append_apart(pool_mod, pa):
    """The parent's decode tick: the append as its own `kv_write` launch
    and host entry, everything else as it is."""
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    return swapped((gpt2_mod, "paged_attention",
                    _append_apart(pool_mod, pa)))


def unfused_serving(pool_mod, pa):
    """The serving tick's unfused launch sequence: the model's residual
    adds as `x + r` before the forward kernel, the decode append apart
    from the decode kernel, and the pool writes as the quantizer kernel
    and index writes (`_kv_write_plain`)."""
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    return swapped((gpt2_mod, "add_layernorm", _add_then_norm),
                   (gpt2_mod, "paged_attention",
                    _append_apart(pool_mod, pa)),
                   (pool_mod, "kv_write", pool_mod._kv_write_plain))


def triton_forward():
    """The parent's LayerNorm forwards: the Triton pair in place of
    csrc/ln_fwd.cu behind `layernorm_fwd` / `add_layernorm_fwd` (the
    autograd Functions look them up at call time)."""
    from tiny_deepspeed_tpu_torch.ops import layernorm as ln
    return swapped(
        (ln, "layernorm_fwd",
         lambda x, w, b, eps=1e-5: ln._ln_fwd_triton(x, w, b, eps)),
        (ln, "add_layernorm_fwd",
         lambda x, r, w, b, eps=1e-5: ln._add_ln_fwd_triton(x, r, w, b,
                                                            eps)))


# the tick's call sites that the port's launch work changed, timed on the
# host, and `linear`, which no arm changes: the control for the host's
# drift between arms.  `paged_attention` carries the decode append;
# where an arm routes the append apart, its time holds the `kv_write`
# call it makes (timed on its own too)
TICK_SITES = (("gpt2", "add_layernorm"), ("gpt2", "layernorm"),
              ("pool", "kv_write"), ("gpt2", "paged_attention"),
              ("gpt2", "linear"))


@contextlib.contextmanager
def site_timers(pool_mod):
    """Each of TICK_SITES (whatever it is bound to: the fused wrapper or
    the unfused sequence) wrapped in a perf_counter pair; yields
    {name: [calls, seconds]}.  The wrapper's own cost (two clock reads
    and a call) falls inside each site's time."""
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    mods = {"gpt2": gpt2_mod, "pool": pool_mod}
    acc = {name: [0, 0.0] for _, name in TICK_SITES}

    class Timed:
        """fn, timed; its launch counter stays fn's (a wrapper counts
        through its module's name, `kv_write.launches += 1`)."""

        def __init__(self, name, fn):
            self.name, self.fn = name, fn

        def __call__(self, *a, **kw):
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            acc[self.name][1] += time.perf_counter() - t0
            acc[self.name][0] += 1
            return out

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, n):
            self.fn.launches = n

    with swapped(*((mods[m], name, Timed(name, getattr(mods[m], name)))
                   for m, name in TICK_SITES)):
        yield acc


def tick_profile(torch, model, prompts, counters, pool_mod, ticks=8,
                 profile=True, **knobs):
    """The decode tick alone: 8 of `prompts` admitted and prefilled (phase
    3's engine), two warm ticks, then `ticks` ticks on the host clock
    (each ends in the tick's token fetch) with every count zeroed before,
    then `ticks` ticks with TICK_SITES timed (`site_timers`), then
    (`profile`) `ticks` profiled ticks.  Returns per tick: host ms, each
    site's calls and host ms, launches by counter, device kernels
    (profiler records) and device busy ms."""
    from tiny_deepspeed_tpu_torch.serving import ServeConfig, ServingEngine
    longest = max(len(p) for p in prompts[:8]) + 64
    cfg = ServeConfig(max_active=8, block_tokens=16,
                      num_blocks=8 * (-(-longest // 16) + 1),
                      max_seq_tokens=longest, **knobs)
    eng = ServingEngine(model, cfg)
    for p in prompts[:8]:
        eng.submit(p, 64)
    for _ in range(3):  # admission + prefill, then two warm decode ticks
        eng.tick()
    check(eng.n_active == 8 and eng.queue_depth == 0,
          "tick_profile: the 8 requests are not all decoding")
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.tick()
    host = (time.perf_counter() - t0) / ticks * 1e3
    out = dict(host_ms=host, launches={k: c.launches / ticks
                                       for k, c in counters.items()
                                       if c.launches})
    torch.cuda.synchronize()
    with site_timers(pool_mod) as acc:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        sites_tick = (time.perf_counter() - t0) / ticks * 1e3
    out["sites"] = {k: (n / ticks, sec / ticks * 1e3)
                    for k, (n, sec) in acc.items()}
    out["sites_tick_ms"] = sites_tick
    if profile:
        prof = profiled(torch, lambda: [eng.tick() for _ in range(ticks)])
        check(prof is not None, "tick_profile: no device time recorded")
        evs = _device_records(torch, prof)
        out.update(kernels=sum(e.count for e in evs) / ticks,
                   busy_ms=sum(_self_device_us(e) for e in evs) / 1e3
                   / ticks)
    check(eng.n_active == 8, "tick_profile: a request ended mid-profile")
    del eng
    return out


def tick_report(torch, model, prompts, counters, pool_mod, name,
                arms=("fused", "unfused"), **knobs):
    """`tick_profile` under each of `arms` — "fused" (the port as it
    is), "apart" (`append_apart`: the decode append as its own kv_write,
    the parent's tick), "unfused" (`unfused_serving`), "triton"
    (`triton_forward`) — in turns (the arms in order, then reversed,
    twice: the host clock drifts over a call), the first of each
    profiled; printed side by side with the host ms a tick and at each
    call site as medians of the four."""
    from tiny_deepspeed_tpu_torch.ops import paged_attn as pa
    swaps = {"fused": contextlib.nullcontext,
             "apart": lambda: append_apart(pool_mod, pa),
             "unfused": lambda: unfused_serving(pool_mod, pa),
             "triton": triton_forward}
    runs = {k: [] for k in arms}
    for k in (tuple(arms) + tuple(arms[::-1])) * 2:
        with swaps[k]():
            runs[k].append(tick_profile(torch, model, prompts, counters,
                                        pool_mod, profile=not runs[k],
                                        **knobs))
    out = {k: dict(v[0], host_ms=statistics.median(r["host_ms"] for r in v),
                   host_runs_ms=[r["host_ms"] for r in v])
           for k, v in runs.items()}
    for k, v in out.items():
        print(f"  {name} decode tick, {k}: {v['kernels']:.2f} device kernels "
              f"a tick, device busy {v['busy_ms']:.4f} ms, host "
              f"{v['host_ms']:.4f} ms (median of "
              f"{[round(x, 4) for x in v['host_runs_ms']]}); launches a "
              f"tick {v['launches']}")
    if "unfused" in out:
        print(f"  {name}: {out['unfused']['kernels'] - out['fused']['kernels']:.2f}"
              " fewer device kernels a tick with the fused kernels")
    if "apart" in out:
        fu, ap = out["fused"], out["apart"]
        print(f"  {name}: the append inside the decode launch: "
              f"{ap['kernels'] - fu['kernels']:.2f} fewer device records a "
              f"tick ({ap['kernels']:.2f} -> {fu['kernels']:.2f}), busy "
              f"{ap['busy_ms']:.4f} -> {fu['busy_ms']:.4f} ms, host "
              f"{ap['host_ms']:.4f} -> {fu['host_ms']:.4f} ms; launches a "
              f"tick kv_write {ap['launches'].get('kv_write', 0):g} -> "
              f"{fu['launches'].get('kv_write', 0):g}, appends "
              f"{ap['launches'].get('paged_attention_append', 0):g} -> "
              f"{fu['launches'].get('paged_attention_append', 0):g}")
        check(fu["launches"].get("kv_write", 0) == 0
              and fu["launches"].get("paged_attention_append", 0)
              == ap["launches"].get("kv_write", 0) > 0
              and ap["launches"].get("paged_attention_append", 0) == 0,
              f"{name}: the tick's appends did not move into the decode "
              f"launch: {fu['launches']} against {ap['launches']}")
    # host ms a tick at each call site, median over the four runs of
    # each arm (interleaved as above): what each arm's wrappers cost the
    # host, `linear` the control
    for k in arms:
        sites = {s: (runs[k][0]["sites"][s][0], statistics.median(
            r["sites"][s][1] for r in runs[k])) for s in runs[k][0]["sites"]}
        tick = statistics.median(r["sites_tick_ms"] for r in runs[k])
        # kv_write's time, where it runs, lies inside paged_attention's
        in_sites = sum(v for s, (_, v) in sites.items()
                       if s not in ("linear", "kv_write"))
        out[k].update(sites=sites, sites_tick_ms=tick)
        print(f"  {name} host a tick at the call sites, {k}: "
              + ", ".join(f"{s} {n:g} calls {ms:.4f} ms ({ms / n * 1e3:.2f} "
                          f"us a call)" for s, (n, ms) in sites.items() if n)
              + f"; {in_sites:.4f} ms of a {tick:.4f} ms tick outside "
              f"`linear` (medians of {len(runs[k])})")
    return out


class Attr:
    """An attribute of a wrapper other than `launches` as a counter of the
    `counters` table, read and zeroed through `launches` like every
    wrapper's: `paged_attention.appends` (the decode launches that carried
    the append), `rmsnorm_bwd.launches_gs`."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


# -- phase 4: training -------------------------------------------------------

TRAIN_KERNELS = ("layernorm_fwd", "layernorm_bwd",
                 "fa2_flash_attention_fwd", "fa2_flash_attention_dq",
                 "fa2_flash_attention_dkv", "add_layernorm_fwd")
FA2_TRAIN = TRAIN_KERNELS[2:5]
# the Triton pair row 2+3 replaced: launched by no training path
LN_PAIR = ("layernorm_dx", "layernorm_dwdb")
KNOB_KERNELS = ("fused_xent_fwd", "fused_xent_dx", "fused_xent_dw",
                "adamw_update_fused")
# profiler kernel-name fragments of each hand-written kernel (the longest
# match wins: "add_ln_fwd_" over "ln_fwd_"); the replaced Triton
# kernels' are REPLACED
PATTERNS = {"layernorm_fwd": "ln_fwd_",
            "add_layernorm_fwd": "add_ln_fwd_",
            "kv_write": "kv_write_kernel",
            "layernorm_dx": "_ln_dx_kernel",
            "layernorm_dwdb": "_ln_dwdb_",
            "layernorm_bwd": "ln_bwd_",
            "fa2_flash_attention_fwd": "flash_fwd_",
            "fa2_flash_attention_dq": "flash_dq_",
            "fa2_flash_attention_dkv": "flash_dkv_",
            "paged_attention": "paged_decode_kernel",
            "fused_xent_fwd": "xent_fwd_",
            "fused_xent_dx": "xent_dx_",
            "fused_xent_dw": "xent_dw_",
            "adamw_update_fused": "_adamw_kernel"}


def plain_ops(ln, fa, fx, af):
    """Every training kernel wrapper swapped for its plain version (the
    autograd Functions and AdamW look their wrappers up at call time)."""
    return swapped((ln, "layernorm_fwd", ln._ln_fwd_plain),
                   (ln, "add_layernorm_fwd", ln._add_ln_fwd_plain),
                   (ln, "layernorm_dx", ln._ln_dx_plain),
                   (ln, "layernorm_dwdb", ln._ln_dwdb_plain),
                   (ln, "layernorm_bwd", ln._ln_bwd_plain),
                   (fa, "fa2_flash_attention_fwd", fa._fa2_fwd_plain),
                   (fa, "fa2_flash_attention_dq", fa._fa2_dq_plain),
                   (fa, "fa2_flash_attention_dkv", fa._fa2_dkv_plain),
                   (fx, "fused_xent_fwd", fx._xent_fwd_plain),
                   (fx, "fused_xent_dx", fx._xent_dx_plain),
                   (fx, "fused_xent_dw", fx._xent_dw_plain),
                   (af, "adamw_update_fused", af._adamw_update_plain))


def check_ln_bwd_launches(launches, cfg, steps, where):
    """Every LayerNorm backward of a training run is one `layernorm_bwd`
    launch (2 norms a block and ln_f, each step) and the Triton pair it
    replaced never runs."""
    want = (2 * cfg.n_layer + 1) * steps
    check(launches["layernorm_bwd"] == want,
          f"{where}: layernorm_bwd launched {launches['layernorm_bwd']} "
          f"times, not {want}")
    check(not any(launches[k] for k in LN_PAIR),
          f"{where}: the Triton pair {LN_PAIR} ran")


# kernel-name fragments of the Triton kernels rows 2+3, 1 and 1r
# replaced, and of the v1 writer kernel: no path may launch them
REPLACED = ("_ln_dx_kernel", "_ln_dwdb_", "_ln_fwd_kernel",
            "_add_ln_fwd_kernel", "kv_write_v1_kernel")


def check_no_pair_records(rows, where):
    """No profiled kernel record of a replaced Triton kernel (REPLACED:
    the backward pair, the forward pair)."""
    bad = [key for _, _, key in rows if any(k in key for k in REPLACED)]
    check(not bad, f"{where}: the profiler recorded {bad}")


def loss_and_grads(torch, model, batch, rng=None):
    idx, tgt = (torch.as_tensor(a, device="cuda").long() for a in batch)
    loss = model.apply(idx, tgt, rng=rng)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


def step_profile(torch, eng, state, batch, name, kernels, med,
                 patterns=PATTERNS):
    """One profiled step: each kernel's device time, the cuBLAS GEMMs,
    everything else (PyTorch's elementwise, reduce and copy kernels) and
    the device's busy and idle shares of the median step wall."""
    def one_step():
        float(eng.step(state, batch)[1])

    prof = profiled(torch, one_step, cpu=True)  # a retry steps again
    check(prof is not None, "the profiler recorded no device time")
    per, busy, rows = kernel_shares(torch, prof, patterns)
    check_no_pair_records(rows, name)
    # cuBLAS's kernels: "*gemm*" and, on Hopper, "nvjet_*"
    gemm = sum(us for us, _, key in rows
               if "gemm" in key.lower() or key.startswith("nvjet"))
    with open(os.path.join(OUT_DIR, name), "w") as f:
        for us, n, key in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    check(busy > 0, "the profiler recorded no device time")
    step_ms = {k: per.get(k, 0.0) / 1e3 for k in kernels}
    other = busy - gemm - sum(per.values())
    print(f"  one profiled step: device busy {busy / 1e3:.3f} ms = "
          f"{busy / 1e3 / (med * 1e3):.4f} of the median step wall "
          f"(idle share {1 - busy / 1e6 / med:.4f}); cuBLAS GEMMs "
          f"{gemm / 1e3:.3f} ms ({gemm / busy:.4f} of busy); other "
          f"(elementwise, reduce, copy) {other / 1e3:.3f} ms "
          f"({other / busy:.4f})")
    for k in kernels:
        print(f"    {k}: {step_ms[k]:.4f} ms per step "
              f"({per.get(k, 0.0) / busy:.4f} of busy)")
    for us, n, key in rows[:12]:
        print(f"    {us / 1e3:10.3f} ms x{n:<6d} {key[:90]}")
    return step_ms, busy, gemm, other


def train_phase(torch, port, counters, ln, fa, fx, af):
    b, t = 8, 1024
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    torch.cuda.reset_peak_memory_stats()
    model = port.GPT2Model(cfg)
    eng = port.SingleDevice(model, port.AdamW(lr=1e-5, weight_decay=0.1))
    state = eng.init(0)
    loader = port.TokenLoader(None, batch=b, seq=t,
                              vocab_size=cfg.vocab_size, seed=0)
    print(f"  {eng.describe()}; gpt2-124m {model.num_params() / 1e6:.1f}M "
          f"params, remat={cfg.remat} policy={cfg.remat_policy}, B={b} "
          f"T={t}")
    losses = []
    for _ in range(3):  # warm-up (Triton compiles, cuBLAS heuristics)
        state, loss = eng.step(state, loader.next())
        losses.append(float(loss))
    for fn in counters.values():
        fn.launches = 0
    ln.layernorm_bwd.launches_gs = 0
    times = []
    for _ in range(10):
        batch = loader.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = eng.step(state, batch)
        losses.append(float(loss))  # the host sync that ends the step
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    with_gs = ln.layernorm_bwd.launches_gs
    # phase 7's world-1 engines must reproduce these 13 steps bit for bit
    after13 = {n: p.detach().clone() for n, p in state.params.items()}
    print(f"  launches on the main path (10 steps): {launches}")
    for k in TRAIN_KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    check_ln_bwd_launches(launches, cfg, 10, "phase 4")
    # AddLayerNormFn's backward (ln_2 of each block) adds gs; LayerNormFn's
    # (ln_1 of each block, ln_f) does not
    check(with_gs == cfg.n_layer * 10,
          f"layernorm_bwd with gs: {with_gs}, not {cfg.n_layer * 10}")
    print(f"  layernorm_bwd: {launches['layernorm_bwd'] - with_gs} launches "
          f"without gs (LayerNormFn), {with_gs} with (AddLayerNormFn); the "
          f"Triton pair 0")
    check(launches["paged_attention"] == 0, "training ran the decode kernel")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(10.5 <= losses[0] <= 11.2,
          f"first loss {losses[0]} outside [10.5, 11.2] (ln 50304 = 10.83)")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  step time median {med * 1e3:.3f} ms (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) -> "
          f"{b * t / med:.1f} tokens/s; peak memory {peak:.2f} GiB")

    step_ms, busy, _, _ = step_profile(torch, eng, state, loader.next(),
                                       "train_profile.txt", TRAIN_KERNELS,
                                       med)

    # one step's gradients: kernel path vs plain path, remat on vs off
    batch = loader.next()
    kl, kg = loss_and_grads(torch, model, batch)
    before = {k: fn.launches for k, fn in counters.items()}
    with plain_ops(ln, fa, fx, af):
        pl, pg = loss_and_grads(torch, model, batch)
    check({k: fn.launches for k, fn in counters.items()} == before,
          "the plain path launched a kernel")
    rel = {n: float((kg[n].float() - pg[n].float()).norm()
                    / pg[n].float().norm().clamp_min(1e-30)) for n in kg}
    worst = max(rel, key=rel.get)
    print(f"  gradients kernel vs plain path on the card: loss {kl:.6f} vs "
          f"{pl:.6f} (tol 1e-2); worst leaf {worst} rel L2 err "
          f"{rel[worst]:.4g} (tol 5e-2)")
    check(abs(kl - pl) <= 1e-2, "loss disagrees with the plain path")
    check(rel[worst] <= 5e-2, "gradients disagree with the plain path")
    model.config = dataclasses.replace(cfg, remat=False)
    try:
        ol, og = loss_and_grads(torch, model, batch)
    finally:
        model.config = cfg
    exact = [n for n in kg if n.startswith("h.")
             or n in ("ln_f.w", "ln_f.b", "lm_head.w", "wpe")]
    differ = [n for n in exact if not torch.equal(kg[n], og[n])]
    wte_diff = float((kg["wte"] - og["wte"]).abs().max())
    wte_rel = float((kg["wte"] - og["wte"]).norm()
                    / og["wte"].norm().clamp_min(1e-30))
    print(f"  remat on vs off: loss {kl!r} vs {ol!r}; {len(exact)} block/"
          f"head/wpe leaves bit-identical: {not differ}; wte (CUDA "
          f"embedding backward) max abs diff {wte_diff:.3g}, rel L2 "
          f"{wte_rel:.3g}")
    check(kl == ol and not differ, f"remat changed the gradients: {differ}")
    check(wte_rel <= 1e-5, "wte gradient differs by more than rounding")
    del kg, pg, og

    # 8 steps at lr=1e-3 on one fixed batch must lower its loss
    eng2 = port.SingleDevice(model, port.AdamW(lr=1e-3, weight_decay=0.1))
    state2 = eng2.init(1)
    fixed = loader.next()
    fit = []
    for _ in range(8):
        state2, loss = eng2.step(state2, fixed)
        fit.append(float(loss))
    print(f"  8 steps at lr=1e-3 on one batch: {[round(x, 4) for x in fit]}")
    check(all(math.isfinite(x) for x in fit) and fit[-1] < fit[0],
          "loss did not fall on a fixed batch")
    return dict(launches=launches, step_ms=med * 1e3,
                tokens_per_s=b * t / med, kernel_ms_per_step=step_ms,
                busy_ms=busy / 1e3, first_loss=losses[0], peak_gib=peak,
                losses13=losses[:13], params13=after13)


def unfused_training_check(torch, port, counters, train):
    """Phase 4's 13 steps again with the model's `add_layernorm` swapped
    for its composition (`x + r`, then LayerNormFn): the losses and the
    params after them must equal phase 4's bit for bit."""
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    with swapped((gpt2_mod, "add_layernorm", _add_then_norm)):
        run = engine_run(torch, port, counters, "SingleDevice",
                         port.GPT2_PRESETS["gpt2-124m"], profile=False,
                         need=TRAIN_KERNELS[:5])
    check(run["launches"]["add_layernorm_fwd"] == 0,
          "the composition launched the fused kernel")
    same = run["losses"] == train["losses13"] and all(
        torch.equal(p, train["params13"][n])
        for n, p in run["params"].items())
    print(f"  13 steps with x + r then LayerNormFn in place of "
          f"add_layernorm: losses and params bit-identical to the fused "
          f"run: {same}; launches over the 10 timed steps: layernorm_fwd "
          f"{run['launches']['layernorm_fwd']} (fused run: "
          f"{train['launches']['layernorm_fwd']} + add_layernorm_fwd "
          f"{train['launches']['add_layernorm_fwd']}); step time median "
          f"{run['step_ms']:.3f} ms (fused run {train['step_ms']:.3f})")
    check(same, f"the composition's 13 steps differ from the fused run's: "
          f"losses {run['losses']} vs {train['losses13']}")
    _free(run)
    return run


def ln_bwd_step_ab(torch, port, ln, runs=6, steps=10):
    """Phase 4's step with row 2+3 (`layernorm_bwd`) and with the
    parent's sequence swapped in (`parent_ln_bwd`: the Triton pair and
    the eager `gs + dx`), in turns in one process: two SingleDevice
    engines from the same init step the same batches, `runs` runs of
    `steps` steps a side, alternating (fused, parent, parent, fused, ...).
    Host-clock step medians, both arms' losses (within phase 4's kernel-
    vs-plain tolerance, 1e-2), and one profiled step a side: busy, idle
    and the LN backward's kernels (device ms and records a step)."""
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    b, t = 8, 1024
    loader = port.TokenLoader(None, batch=b, seq=t,
                              vocab_size=cfg.vocab_size, seed=0)
    batches = [loader.next() for _ in range(3 + runs * steps + 1)]
    arms = {}
    for name in ("fused", "parent"):
        model = port.GPT2Model(cfg)
        eng = port.SingleDevice(model, port.AdamW(lr=1e-5,
                                                  weight_decay=0.1))
        arms[name] = dict(eng=eng, state=eng.init(0), losses=[], times=[])
    parent = parent_ln_bwd(ln)

    def run(name, chunk, timed):
        arm = arms[name]
        ctx = (swapped((ln, "layernorm_bwd", parent)) if name == "parent"
               else contextlib.nullcontext())
        with ctx:
            for batch in chunk:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                arm["state"], loss = arm["eng"].step(arm["state"], batch)
                arm["losses"].append(float(loss))
                if timed:
                    arm["times"].append(time.perf_counter() - t0)

    for name in arms:
        run(name, batches[:3], False)  # warm-up (the Triton compiles too)
    for k in range(runs):
        chunk = batches[3 + k * steps:3 + (k + 1) * steps]
        for name in (("fused", "parent") if k % 2 == 0
                     else ("parent", "fused")):
            run(name, chunk, True)
    diff = max(abs(a - c) for a, c in zip(arms["fused"]["losses"],
                                          arms["parent"]["losses"]))
    check(diff <= 1e-2, f"the LN backward A/B: losses differ by {diff}")
    pats = {"ln_bwd": "ln_bwd_", "ln_dx": "_ln_dx_kernel",
            "ln_dwdb": "_ln_dwdb_"}
    out = {}
    for name, arm in arms.items():
        med = statistics.median(arm["times"])
        ctx = (swapped((ln, "layernorm_bwd", parent)) if name == "parent"
               else contextlib.nullcontext())
        with ctx:
            prof = profiled(torch, lambda: float(arm["eng"].step(
                arm["state"], batches[-1])[1]), cpu=True)
        check(prof is not None, "the profiler recorded no device time")
        cuda = torch.autograd.DeviceType.CUDA
        per, busy, rec = {}, 0.0, {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != cuda:
                continue
            us = _self_device_us(e)
            busy += us
            for k, pat in pats.items():
                if pat in e.key:
                    per[k] = per.get(k, 0.0) + us
                    rec[k] = rec.get(k, 0) + e.count
        out[name] = dict(step_ms=med * 1e3, step_min_ms=min(arm["times"]) * 1e3,
                         step_max_ms=max(arm["times"]) * 1e3,
                         busy_ms=busy / 1e3, idle=1 - busy / 1e6 / med,
                         ln_bwd_ms={k: v / 1e3 for k, v in per.items()},
                         ln_bwd_records=rec)
        print(f"  LN backward A/B, {name}: step median {med * 1e3:.3f} ms "
              f"[{min(arm['times']) * 1e3:.3f}, {max(arm['times']) * 1e3:.3f}]"
              f" over {len(arm['times'])} steps ({runs} runs of {steps}, in "
              f"turns); one profiled step: busy {busy / 1e3:.3f} ms, idle "
              f"{1 - busy / 1e6 / med:.4f}; LN backward kernels "
              f"{ {k: round(v / 1e3, 4) for k, v in per.items()} } ms, "
              f"records {rec}" + (" (+ 12 eager gs + dx adds)"
                                  if name == "parent" else ""))
    print(f"  LN backward A/B: step fused / parent "
          f"{out['fused']['step_ms'] / out['parent']['step_ms']:.4f}, busy "
          f"{out['fused']['busy_ms'] - out['parent']['busy_ms']:+.3f} ms; "
          f"losses of the {len(arms['fused']['losses'])} steps within "
          f"{diff:.3g} (tol 1e-2)")
    out["loss_diff"] = diff
    del arms
    return out


def _leaf_rel(torch, a, b):
    """{leaf: rel L2 err of a's gradient against b's}."""
    return {n: float((a[n].float() - b[n].float()).norm()
                     / b[n].float().norm().clamp_min(1e-30)) for n in a}


def knobbed_phase(torch, port, counters, ln, fa, fx, af):
    """gpt2-124m at full width and depth with every knob of the slice: the
    fused head (fused_xent_impl="pallas"), AdamW(fused=True) and GPT-2's
    published dropout 0.1; f32 masters, bf16 compute, remat
    "dots_no_batch"; B=8, T=1024 from TokenLoader(seed=0)."""
    b, t = 8, 1024
    cfg = dataclasses.replace(port.GPT2_PRESETS["gpt2-124m"],
                              fused_xent=True, fused_xent_impl="pallas",
                              dropout=0.1)
    torch.cuda.reset_peak_memory_stats()
    model = port.GPT2Model(cfg)
    eng = port.SingleDevice(model, port.AdamW(lr=1e-5, weight_decay=0.1,
                                              fused=True))
    state = eng.init(0)
    loader = port.TokenLoader(None, batch=b, seq=t,
                              vocab_size=cfg.vocab_size, seed=0)
    print(f"  {eng.describe()}; gpt2-124m, fused_xent_impl="
          f"{cfg.fused_xent_impl} ({port.effective_xent_impl(cfg)}), "
          f"dropout={cfg.dropout}, AdamW(fused=True), remat={cfg.remat} "
          f"policy={cfg.remat_policy}, B={b} T={t}")
    losses = []
    for _ in range(3):
        state, loss = eng.step(state, loader.next())
        losses.append(float(loss))
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(10):
        batch = loader.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = eng.step(state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  launches on the main path (10 steps): {launches}")
    for k in TRAIN_KERNELS + KNOB_KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the knobbed path")
    check_ln_bwd_launches(launches, cfg, 10, "phase 5")
    check(launches["dropout"] == 10 * dropout_launches_per_step(cfg),
          f"phase 5: dropout launches {launches['dropout']}, want 10 x "
          f"{dropout_launches_per_step(cfg)}")
    check(launches["paged_attention"] == 0, "training ran the decode kernel")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(10.5 <= losses[0] <= 11.2,
          f"first loss {losses[0]} outside [10.5, 11.2] (ln 50304 = 10.83)")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  step time median {med * 1e3:.3f} ms (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) -> "
          f"{b * t / med:.1f} tokens/s; peak memory {peak:.2f} GiB")
    step_ms, busy, gemm, other = step_profile(
        torch, eng, state, loader.next(), "knobbed_profile.txt",
        TRAIN_KERNELS + KNOB_KERNELS, med)

    # fused head vs default and chunked heads: one batch, same weights, no
    # dropout (no rng)
    batch = loader.next()
    kl, kg = loss_and_grads(torch, model, batch)
    heads = {}
    try:
        for name, over in (("default", dict(fused_xent=False)),
                           ("chunked", dict(fused_xent_impl="chunked"))):
            model.config = dataclasses.replace(cfg, **over)
            heads[name] = loss_and_grads(torch, model, batch)
    finally:
        model.config = cfg
    dl, dg = heads["default"]
    for name, (hl, hg) in (("pallas", (kl, kg)),
                           ("chunked", heads["chunked"])):
        rel = _leaf_rel(torch, hg, dg)
        worst = max(rel, key=rel.get)
        print(f"  {name} head vs default head: loss {hl:.6f} vs {dl:.6f} "
              f"(tol 1e-2); worst leaf {worst} rel L2 err {rel[worst]:.4g} "
              "(tol 5e-2)")
        check(abs(hl - dl) <= 1e-2 and rel[worst] <= 5e-2,
              f"the {name} head disagrees with the default head")
    del heads, dg

    # kernel path vs plain path
    before = {k: fn.launches for k, fn in counters.items()}
    with plain_ops(ln, fa, fx, af):
        pl, pg = loss_and_grads(torch, model, batch)
    check({k: fn.launches for k, fn in counters.items()} == before,
          "the plain path launched a kernel")
    rel = _leaf_rel(torch, kg, pg)
    worst = max(rel, key=rel.get)
    print(f"  kernel vs plain path: loss {kl:.6f} vs {pl:.6f} (tol 1e-2); "
          f"worst leaf {worst} rel L2 err {rel[worst]:.4g} (tol 5e-2)")
    check(abs(kl - pl) <= 1e-2 and rel[worst] <= 5e-2,
          "the knobbed path disagrees with its plain path")
    del pg

    # one fused AdamW update vs fused=False from the same state
    params = {n: p.detach() for n, p in model.named_parameters()}
    outs = []
    for fused in (True, False):
        opt = port.AdamW(lr=1e-3, weight_decay=0.1, fused=fused)
        ps = {n: p.clone() for n, p in params.items()}
        st = opt.init(ps)
        opt.update(ps, kg, st)
        outs.append((ps, st))
    torch.cuda.synchronize()
    worst = 0.0
    for n in params:
        (fp, fs), (up, us) = outs[0], outs[1]
        for got, ref in ((fp[n], up[n]), (fs["state"][n]["m"],
                                          us["state"][n]["m"]),
                         (fs["state"][n]["v"], us["state"][n]["v"])):
            scale = max(float(ref.abs().max()), 1e-30)
            worst = max(worst, max_err(got, ref) / scale)
    print(f"  AdamW(fused=True) vs fused=False, one update of all leaves: "
          f"max abs err {worst:.3g} x max|ref| of each p, m, v (tol 1e-6)")
    check(worst <= 1e-6, "the fused AdamW update disagrees with fused=False")
    del outs, kg

    # dropout: the same seed gives the same losses; remat redraws the masks
    runs = []
    fixed = [loader.next() for _ in range(3)]
    for _ in range(2):
        st = eng.init(0)
        runs.append([float(eng.step(st, bt)[1]) for bt in fixed])
    print(f"  dropout: two engines from seed 0, 3 steps: {runs[0]} / "
          f"{runs[1]}")
    check(runs[0] == runs[1], "the same seed gave other losses")
    key = 0xC0FFEE
    rl, rg = loss_and_grads(torch, model, batch, rng=key)
    model.config = dataclasses.replace(cfg, remat=False)
    try:
        ol, og = loss_and_grads(torch, model, batch, rng=key)
    finally:
        model.config = cfg
    exact = [n for n in rg if n.startswith("h.")
             or n in ("ln_f.w", "ln_f.b", "lm_head.w", "wpe")]
    differ = [n for n in exact if not torch.equal(rg[n], og[n])]
    wte_rel = float((rg["wte"] - og["wte"]).norm()
                    / og["wte"].norm().clamp_min(1e-30))
    print(f"  dropout remat on vs off: loss {rl!r} vs {ol!r}; {len(exact)} "
          f"block/head/wpe leaves bit-identical: {not differ}; wte rel L2 "
          f"{wte_rel:.3g}")
    check(rl == ol and not differ, f"remat changed dropout grads: {differ}")
    check(wte_rel <= 1e-5, "wte gradient differs by more than rounding")
    del rg, og
    ev = [float(eng.eval_loss(st, batch)) for _ in range(2)]
    model.config = dataclasses.replace(cfg, dropout=0.0)
    try:
        ev.append(float(eng.eval_loss(st, batch)))
    finally:
        model.config = cfg
    print(f"  eval_loss twice and with dropout=0: {ev}; the same batch's "
          f"training loss with dropout {rl:.6f}")
    check(ev[0] == ev[1] == ev[2], "eval_loss depends on dropout")
    check(rl != ev[0], "dropout 0.1 left the loss unchanged")

    # 8 steps at lr=1e-3 on one fixed batch must lower its loss
    eng2 = port.SingleDevice(model, port.AdamW(lr=1e-3, weight_decay=0.1,
                                               fused=True))
    state2 = eng2.init(1)
    fit = []
    for _ in range(8):
        state2, loss = eng2.step(state2, fixed[0])
        fit.append(float(loss))
    print(f"  8 steps at lr=1e-3 on one batch: {[round(x, 4) for x in fit]}")
    check(all(math.isfinite(x) for x in fit) and fit[-1] < fit[0],
          "loss did not fall on a fixed batch")
    return dict(launches=launches, step_ms=med * 1e3,
                tokens_per_s=b * t / med, kernel_ms_per_step=step_ms,
                busy_ms=busy / 1e3, first_loss=losses[0], peak_gib=peak)


# -- phase 6: serving variants ------------------------------------------------

# (path name, ServeConfig knobs) over phase 3's traffic
SERVE_VARIANTS = (("spec_ngram", dict(spec_draft="ngram", spec_k=4)),
                  ("spec_model_self", dict(spec_draft="model:self",
                                           spec_k=4)),
                  ("quant_int8", dict(quant="int8")),
                  ("quant_fp8", dict(quant="fp8")))
# the kernels each path must launch (the drafter's apart)
SERVE_BASE = ("layernorm_fwd", "add_layernorm_fwd",
              "fa2_flash_attention_fwd", "kv_write")
# (every decode launch carries its layer's append)
VARIANT_KERNELS = {
    "spec_ngram": SERVE_BASE + ("paged_attention_span",),
    "spec_model_self": SERVE_BASE + ("paged_attention_span",),
    "spec_model_self_drafter": SERVE_BASE + ("paged_attention",
                                             "paged_attention_append"),
    "quant_int8": SERVE_BASE + ("paged_attention_quant",
                                "paged_attention_append"),
    "quant_fp8": SERVE_BASE + ("paged_attention_quant",
                               "paged_attention_append"),
    "prefix_on": SERVE_BASE + ("paged_attention", "paged_attention_span",
                               "paged_attention_append"),
    "prefix_off": SERVE_BASE + ("paged_attention", "paged_attention_append"),
}
SERVE_PATTERNS = {"layernorm_fwd": "ln_fwd_",
                  "add_layernorm_fwd": "add_ln_fwd_",
                  "kv_write": "kv_write_kernel",
                  "fa2_flash_attention_fwd": "flash_fwd_",
                  "paged_attention": "paged_decode_kernel",
                  "paged_attention_span": "paged_span_",
                  "quantize_blockwise": "_quant_kernel"}


def prefix_traffic(np):
    """16 requests, each a shared 256-token prefix (seed 1) plus a
    private suffix of 16-128 tokens (seed 2), and the 64 new tokens each
    asks for."""
    shared = np.random.default_rng(1).integers(0, 50257, 256).tolist()
    rng = np.random.default_rng(2)
    lens = rng.integers(16, 129, size=16)
    return [shared + rng.integers(0, 50257, int(n)).tolist()
            for n in lens], 64


def serve_variant(torch, model, prompts, new, counters, profile=False,
                  **knobs):
    """Phase 3's engine with `knobs`; every count zeroed just before the
    drive and read just after.  Returns (engine, requests, wall, segment
    times, launches, the drafter's share of them, profile)."""
    from tiny_deepspeed_tpu_torch.serving import ServeConfig, ServingEngine
    longest = max(len(p) for p in prompts) + new
    per_req = -(-longest // 16) + 1
    cfg = ServeConfig(max_active=8, block_tokens=16, num_blocks=8 * per_req,
                      max_seq_tokens=longest, **knobs)
    eng = ServingEngine(model, cfg)
    seg = {"prefill_s": 0.0, "decode_s": 0.0, "decode_ticks": 0}
    dname = "_decode_spec" if eng._spec is not None else "_decode_plain"
    pre, dec = eng._prefill_step, getattr(eng, dname)

    def timed_prefill(*a):
        t = time.perf_counter()
        try:
            return pre(*a)  # ends in a host sync (the sampled token)
        finally:
            seg["prefill_s"] += time.perf_counter() - t

    def timed_decode(*a):
        t = time.perf_counter()
        try:
            return dec(*a)  # ends in a host sync (the token fetch)
        finally:
            seg["decode_s"] += time.perf_counter() - t
            seg["decode_ticks"] += 1

    eng._prefill_step = timed_prefill
    setattr(eng, dname, timed_decode)
    drafter = dict.fromkeys(counters, 0)
    if eng._spec is not None:  # the drafter's launches, kept apart
        d = eng._spec.drafter
        for name in ("propose", "on_admit"):
            def counted(*a, _f=getattr(d, name)):
                before = {k: c.launches for k, c in counters.items()}
                try:
                    return _f(*a)
                finally:
                    for k, c in counters.items():
                        drafter[k] += c.launches - before[k]
            setattr(d, name, counted)
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new) for p in prompts]
    prof = None
    if profile:
        prof = profiled(torch, lambda: eng.drain(max_ticks=10_000), tries=1)
    else:
        eng.drain(max_ticks=10_000)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches - drafter[k] for k, c in counters.items()}
    return eng, reqs, wall, seg, launches, drafter, prof


def plain_serving_ops(pa, pool_mod, qm):
    """Every serving kernel wrapper the model and the pool call swapped for
    its plain version: layernorm (with and without the residual add), FA2,
    paged attention, the pool write and its quantizer."""
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    from tiny_deepspeed_tpu_torch.ops.flash_fa2 import _fa2_fwd_plain
    from tiny_deepspeed_tpu_torch.ops.layernorm import (_add_ln_fwd_plain,
                                                        _ln_fwd_plain)

    return swapped(
        (gpt2_mod, "layernorm", lambda x, w, b, eps=1e-5:
         _ln_fwd_plain(x, w, b, eps)[0]),
        (gpt2_mod, "add_layernorm", lambda x, r, w, b, eps=1e-5:
         _add_ln_fwd_plain(x, r, w, b, eps)[:2]),
        (gpt2_mod, "sharded_attention", lambda q, k_, v, impl, pctx=None:
         _fa2_fwd_plain(q, k_, v)[0]),
        (gpt2_mod, "paged_attention",
         lambda q, view, page, l, span_kv=None, append_kv=None:
         pa._paged_attention_plain(q, view, page, l, span_kv, append_kv)),
        (pool_mod, "kv_write", pool_mod._kv_write_plain),
        (pool_mod, "quantize_blockwise",
         lambda x, mode, block=256, dither=None:
         qm._quantize_plain(x.reshape(-1), mode, block, dither)))


def verify_logits_check(torch, np, model, prompts, plain, counters):
    """One verify tick's (S, K1, V) logits — 8 slots admitted, then the
    span [head, 4 ngram drafts] scored over the committed pool — on the
    kernel path and on the plain path (same pool, read-only; the plain
    path must launch no kernel)."""
    from tiny_deepspeed_tpu_torch.serving import ServeConfig, ServingEngine
    from tiny_deepspeed_tpu_torch.serving.pool import page_ref
    eng = ServingEngine(model, ServeConfig(
        max_active=8, block_tokens=16, num_blocks=8 * 38, max_seq_tokens=600,
        spec_draft="ngram", spec_k=4))
    for p in prompts[:8]:
        eng.submit(p, 64)
    eng._admit()
    active = [(i, s) for i, s in enumerate(eng._slots) if s is not None]
    drafts = eng._spec.propose(eng._slots)
    tokens, pos, *_, tables = eng._slot_arrays(active)
    span = torch.from_numpy(np.concatenate(
        [tokens[:, None], drafts[:, :4]], 1)).cuda()
    pos_t, tables_t = (torch.from_numpy(a).cuda() for a in (pos, tables))
    positions = (pos_t.long()[:, None]
                 + torch.arange(5, device="cuda")[None, :]).clamp(max=1023)

    @torch.no_grad()
    def run():
        x = model._embed_decode_span(span, positions)
        page = page_ref(tables_t, pos_t, 16)
        x, _, _ = model.paged_verify(eng._stacked, x, eng.pool.view, page)
        return model.head_span(x, params=eng._head)

    kern = run()
    before = {k: c.launches for k, c in counters.items()}
    with plain():
        ref = run()
    check({k: c.launches for k, c in counters.items()} == before,
          "the plain path launched a kernel")
    return kern, ref


def quant_prefill_check(torch, model, prompt, mode, plain, counters):
    """A prefill into an int8 / fp8 pool (mode None: a pool in the
    compute dtype) and the decode step after it (the writer fills the
    pool, the decode kernel reads it), on the kernel path and on the
    plain path: (prefill logits, decode logits) each."""
    from tiny_deepspeed_tpu_torch.serving.pool import PagedKVPool, page_ref
    c = model.config
    p = len(prompt)
    bucket = max(16, 1 << (p - 1).bit_length())
    idx = torch.zeros(1, bucket, dtype=torch.long, device="cuda")
    idx[0, :p] = torch.tensor(prompt, device="cuda")
    nblk = bucket // 16 + 1
    ids = torch.arange(1, bucket // 16 + 1, device="cuda")
    tables = torch.arange(1, nblk + 1, dtype=torch.int32,
                          device="cuda")[None]
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")

    @torch.no_grad()
    def run():
        pool = PagedKVPool(n_layer=c.n_layer,
                           kv_heads=getattr(c, "kv_heads", c.n_head),
                           head_dim=c.head_dim, num_blocks=nblk,
                           block_tokens=16, dtype=torch.bfloat16,
                           quant=mode, device="cuda")
        lp, _ = model.paged_prefill(idx, p - 1, ids, pool.view, 16)
        tok = lp.argmax(-1)
        x = model._embed_decode(tok, pos)
        x, _ = model.paged_decode(model.stacked_compute_params(), x,
                                  pool.view, page_ref(tables, pos, 16))
        return lp, model.head(x)[:, 0]

    kern = run()
    before = {k: c.launches for k, c in counters.items()}
    with plain():
        ref = run()
    check({k: c.launches for k, c in counters.items()} == before,
          "the plain path launched a kernel")
    return kern, ref


def _agree(a, b):
    """Share of token positions on which two runs' streams agree."""
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def variants_phase(torch, np, model, counters, pa, pool_mod, qm,
                   plain_tokens):
    """Phase 6: gpt2-124m bf16 at full depth under speculative decoding
    (ngram and model:self, spec_k=4), int8 and fp8 pools (phase 3's 16
    requests) and the prefix cache on and off (a shared-prefix mix), then
    the logits checks.  `plain_tokens`: phase 3's streams, for the bf16
    token agreement (reported, not gated)."""
    prompts, new = serving_traffic(np)
    pprompts, pnew = prefix_traffic(np)
    runs = [(name, prompts, new, knobs) for name, knobs in SERVE_VARIANTS]
    runs += [("prefix_on", pprompts, pnew, dict(prefix_cache=True)),
             ("prefix_off", pprompts, pnew, {})]
    # warm every variant's shapes once (Triton compiles, cuBLAS heuristics)
    for _, ps, _, knobs in runs:
        serve_variant(torch, model, [ps[0][:24], ps[1][:300]], 4, counters,
                      **knobs)
    paths, tokens, results = {}, {}, {}
    for name, ps, nw, knobs in runs:
        eng, reqs, wall, seg, launches, drafter, _ = serve_variant(
            torch, model, ps, nw, counters, **knobs)
        paths[name] = launches
        if knobs.get("spec_draft", "").startswith("model:"):
            paths[name + "_drafter"] = drafter
        if eng._spec is not None:
            check(launches["paged_attention"] == 0,
                  f"{name}: the target ran the plain decode kernel")
        statuses = [r.status for r in reqs]
        check(all(s == "ok" for s in statuses), f"{name}: statuses "
              f"{statuses}")
        check(all(len(r.tokens) == nw for r in reqs), f"{name}: short "
              "token streams")
        check(all(0 <= t < model.config.vocab_size for r in reqs
                  for t in r.tokens), f"{name}: token ids out of range")
        check(eng.restarts == 0, f"{name}: {eng.restarts} warm restart(s)")
        held = len(set(eng._prefix.blocks())) if eng._prefix else 0
        check(eng.pool.blocks_in_use == held, f"{name}: pool blocks leaked")
        for path in (name, name + "_drafter"):
            for k in VARIANT_KERNELS.get(path, ()):
                check(paths[path][k] > 0,
                      f"{k} was never launched on the {path} path")
        quiet = [k for k in counters if k not in
                 VARIANT_KERNELS[name] + VARIANT_KERNELS.get(
                     name + "_drafter", ())]
        check(not any(launches[k] or drafter[k] for k in quiet),
              f"{name} ran kernels outside its path: "
              f"{ {k: launches[k] + drafter[k] for k in quiet} }")
        total = sum(len(r.tokens) for r in reqs)
        dec_tok = total - len(reqs)
        ttft = statistics.median(r.t_first - r.t_arrival for r in reqs)
        out = dict(wall_s=wall, decode_tok_s=dec_tok / seg["decode_s"],
                   ttft_p50_ms=ttft * 1e3, prefill_s=seg["prefill_s"],
                   decode_s=seg["decode_s"], ticks=seg["decode_ticks"],
                   launches=launches)
        extra = ""
        if eng._spec is not None:
            st = dict(proposed=eng._spec_proposed,
                      accepted=eng._spec_accepted,
                      acceptance=eng._spec_accepted
                      / max(1, eng._spec_proposed),
                      ticks=eng._spec_ticks, tokens=eng._spec_tokens)
            out.update(spec=st, drafter_launches=drafter)
            extra = (f"; acceptance {st['accepted']}/{st['proposed']} = "
                     f"{st['acceptance']:.4f}, {st['tokens']} tokens in "
                     f"{st['ticks']} verify ticks; drafter launches "
                     f"{ {k: v for k, v in drafter.items() if v} }")
        if eng._prefix is not None:
            st = eng.prefix_stats()
            out.update(prefix=st)
            extra = (f"; aliased blocks {st['blocks_aliased']}, prefill "
                     f"tokens skipped {st['prefill_tokens_avoided']} of "
                     f"{st['prompt_tokens']} (hit rate {st['hit_rate']})")
        if knobs.get("quant"):
            kb = eng.pool.kv_bytes()
            bf16 = 2 * eng.pool.view.k.numel() * 2  # same geometry in bf16
            out.update(kv_bytes=kb, kv_bytes_bf16=bf16)
            extra = (f"; kv_bytes {kb['total_bytes']} ({kb['dtype']}, "
                     f"scales {kb['scale_bytes']}) vs {bf16} for a bf16 "
                     f"pool of the same geometry = "
                     f"{kb['total_bytes'] / bf16:.4f}")
        print(f"  {name}: 16 requests ok, {total} tokens in {wall:.4f}s; "
              f"decode {dec_tok} tokens in {seg['decode_ticks']} ticks, "
              f"{seg['decode_s']:.4f}s -> {out['decode_tok_s']:.2f} decode "
              f"tok/s; prefill {seg['prefill_s']:.4f}s; TTFT p50 "
              f"{ttft * 1e3:.2f} ms; launches "
              f"{ {k: v for k, v in launches.items() if v} }{extra}")
        tokens[name] = [r.tokens for r in reqs]
        results[name] = out
        del eng
        torch.cuda.empty_cache()

    # device busy / idle: a second, profiled pass of each path
    for name, ps, nw, knobs in runs:
        for _ in range(3):  # an empty CUPTI trace: serve the traffic again
            *_, prof = serve_variant(torch, model, ps, nw, counters,
                                     profile=True, **knobs)
            if prof is not None:
                break
        check(prof is not None, f"{name}: the profiler recorded no device "
              "time")
        per, busy, rows = kernel_shares(torch, prof, SERVE_PATTERNS)
        check_no_pair_records(rows, f"{name}'s profiled pass")
        with open(os.path.join(OUT_DIR, f"{name}_profile.txt"), "w") as f:
            for us, n, key in rows:
                f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
        wall = results[name]["wall_s"]
        results[name].update(busy_s=busy / 1e6, idle_share=1 - busy / 1e6
                             / wall, kernel_s={k: v / 1e6 for k, v in
                                               per.items()})
        print(f"  {name}: device busy {busy / 1e6:.4f}s of the main run's "
              f"{wall:.4f}s wall (idle share {1 - busy / 1e6 / wall:.4f}); "
              "kernel device s "
              f"{ {k: round(v / 1e6, 5) for k, v in per.items()} }")

    def plain():
        return plain_serving_ops(pa, pool_mod, qm)

    kern, ref = verify_logits_check(torch, np, model, prompts, plain,
                                    counters)
    err, scale = max_err(kern, ref), float(ref.abs().max())
    print(f"  one verify tick's (S, K1, V) = {tuple(kern.shape)} logits vs "
          f"the plain path on the card: max_abs_err={err:.4g}, max|logit|="
          f"{scale:.4g} (tol 5e-2 x max|logit|)")
    check(kern.shape == (8, 5, model.config.vocab_size)
          and bool(torch.isfinite(kern).all()), "verify logits malformed")
    check(err <= 5e-2 * scale, "verify logits disagree with the plain path")
    for mode in ("int8", "fp8"):
        (kp, kd), (rp, rd) = quant_prefill_check(torch, model, prompts[0],
                                                 mode, plain, counters)
        e = [max_err(kp, rp), max_err(kd, rd)]
        sc = [float(rp.abs().max()), float(rd.abs().max())]
        print(f"  {mode} pool: prefill logits max_abs_err={e[0]:.4g} "
              f"(max|logit| {sc[0]:.4g}), first decode step over the "
              f"quantized pool max_abs_err={e[1]:.4g} (max|logit| "
              f"{sc[1]:.4g}) vs the plain path (tol 5e-2 x max|logit|)")
        check(all(bool(torch.isfinite(t).all()) for t in (kp, kd)),
              f"{mode} logits not finite")
        check(e[0] <= 5e-2 * sc[0] and e[1] <= 5e-2 * sc[1],
              f"{mode} prefill/decode logits disagree with the plain path")
    # bf16 token agreement with plain serving (reported, not gated)
    agree = {name: round(_agree(plain_tokens, tokens[name]), 4)
             for name, *_ in runs[:len(SERVE_VARIANTS)]}
    agree["prefix_on_vs_off"] = round(_agree(tokens["prefix_off"],
                                             tokens["prefix_on"]), 4)
    print(f"  bf16 token agreement with plain serving (not gated): {agree}")
    return paths, results, agree


def f32_identity(torch, np, port, model, counters):
    """gpt2-124m in f32 (same weights): 8 of phase 3's requests and 8 of
    the shared-prefix mix, 32 new tokens each.  The greedy tokens of
    plain, spec-ngram and spec-model:self must be identical, and those
    of the prefix cache on and off."""
    cfg = dataclasses.replace(model.config, compute_dtype=torch.float32)
    m32 = port.GPT2Model(cfg)
    m32.load_state_dict(model.state_dict())
    prompts, _ = serving_traffic(np)
    pprompts, _ = prefix_traffic(np)
    out = {}
    for name, ps, knobs in (
            ("plain", prompts[:8], {}),
            ("spec_ngram", prompts[:8], dict(spec_draft="ngram", spec_k=4)),
            ("spec_model_self", prompts[:8], dict(spec_draft="model:self",
                                                  spec_k=4)),
            ("prefix_off", pprompts[:8], {}),
            ("prefix_on", pprompts[:8], dict(prefix_cache=True))):
        eng, reqs, *_ = serve_variant(torch, m32, ps, 32, counters, **knobs)
        check(all(r.status == "ok" for r in reqs), f"f32 {name} failed")
        out[name] = [r.tokens for r in reqs]
        if eng._prefix is not None:
            out["prefix_aliased"] = eng.prefix_stats()["blocks_aliased"]
    same_spec = out["plain"] == out["spec_ngram"] == out["spec_model_self"]
    same_prefix = out["prefix_on"] == out["prefix_off"]
    print(f"  f32 gpt2-124m, 8 requests x 32 tokens: plain == spec-ngram "
          f"== spec-model:self: {same_spec}; prefix cache on == off: "
          f"{same_prefix} ({out['prefix_aliased']} blocks aliased)")
    check(same_spec, "f32 spec tokens differ from plain greedy: "
          f"{[_agree(out['plain'], out[k]) for k in ('spec_ngram', 'spec_model_self')]}")
    check(same_prefix, "f32 prefix-cache tokens differ from cache off: "
          f"{_agree(out['prefix_off'], out['prefix_on'])}")
    check(out["prefix_aliased"] > 0, "the f32 prefix run aliased nothing")
    del m32
    torch.cuda.empty_cache()
    return out


# -- phase 7: distributed ---------------------------------------------------

CHUNK_KERNELS = ("fa2_chunk_fwd", "fa2_chunk_dq", "fa2_chunk_dkv")
# ring attention's shape on gpt2-124m at T=1024 split over 4 seq ranks
RING_B, RING_H, RING_T, RING_D, RING_N = 8, 12, 1024, 64, 4
RING_TL = RING_T // RING_N


def chunk_phase(torch, F, fa):
    """7a: the unmasked chunk kernels (4c, 5c, 6c) at the ring's shape,
    B=8 H=12 Tl=256 Dh=64 bf16, against their plain versions (forward:
    atol = rtol = 2e-2, lse 2e-3; backward: max abs err <= 2e-2 x
    max |plain|), each run twice and bit-identical; times beside the
    bound, the plain version and SDPA without a mask (its backward for dq
    and dk/dv), timed only as a yardstick."""
    b, h, t, d = RING_B, RING_H, RING_TL, RING_D
    g = torch.Generator(device="cuda").manual_seed(77)
    q, k, v, do = (torch.randn(b, h, t, d, generator=g, device="cuda"
                               ).bfloat16() for _ in range(4))
    o, lse = fa.fa2_chunk_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    po, plse = fa._fa2_fwd_plain(q, k, v, causal=False)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)
    fwd_err = max_err(o, po)
    # the backward takes the ring's GLOBAL stats: this chunk's lse merged
    # with another chunk's
    lse_g = torch.logaddexp(lse, lse - 0.5)
    di = (do.float() * o.float()).sum(-1)
    dq = fa.fa2_chunk_dq(q, k, v, do, lse_g, di, causal=False)
    dk, dv = fa.fa2_chunk_dkv(q, k, v, do, lse_g, di, causal=False)
    torch.cuda.synchronize()
    pdq = fa._fa2_dq_plain(q, k, v, do, lse_g, di, causal=False)
    pdk, pdv = fa._fa2_dkv_plain(q, k, v, do, lse_g, di, causal=False)
    dq_err, dq_rel = _rel_err(dq, pdq)
    kv = [_rel_err(dk, pdk), _rel_err(dv, pdv)]
    dkv_err, dkv_rel = max(e for e, _ in kv), max(r for _, r in kv)
    check(dq_rel <= 2e-2 and dkv_rel <= 2e-2,
          f"chunk backward disagrees with its plain version: dq rel "
          f"{dq_rel:.3g}, dk/dv rel {dkv_rel:.3g}")
    _bitwise(torch, lambda: fa.fa2_chunk_fwd(q, k, v, causal=False),
             "chunk fwd")
    _bitwise(torch, lambda: [fa.fa2_chunk_dq(q, k, v, do, lse_g, di,
                                             causal=False)], "chunk dq")
    _bitwise(torch, lambda: fa.fa2_chunk_dkv(q, k, v, do, lse_g, di,
                                             causal=False), "chunk dkv")

    qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
    outr = F.scaled_dot_product_attention(qr, kr, vr, is_causal=False)

    def lib_bwd():
        return torch.autograd.grad(outr, (qr, kr, vr), do, retain_graph=True)

    lib_bwd_ms = device_ms(torch, lib_bwd)

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=False)

    panel = b * h * t * d * 2
    stats = b * h * t * 4
    sq = b * h * t * t * d
    res = {}
    for name, kernel, plain, library, lib_ms, nbytes, flops, err in (
            ("fa2_chunk_fwd",
             lambda: fa.fa2_chunk_fwd(q, k, v, causal=False),
             lambda: fa._fa2_fwd_plain(q, k, v, causal=False), lib_fwd,
             device_ms(torch, lib_fwd), 4 * panel + stats, 4 * sq, fwd_err),
            ("fa2_chunk_dq",
             lambda: fa.fa2_chunk_dq(q, k, v, do, lse_g, di, causal=False),
             lambda: fa._fa2_dq_plain(q, k, v, do, lse_g, di, causal=False),
             lib_bwd, lib_bwd_ms, 5 * panel + 2 * stats, 6 * sq, dq_err),
            ("fa2_chunk_dkv",
             lambda: fa.fa2_chunk_dkv(q, k, v, do, lse_g, di, causal=False),
             lambda: fa._fa2_dkv_plain(q, k, v, do, lse_g, di,
                                       causal=False),
             lib_bwd, lib_bwd_ms, 6 * panel + 2 * stats, 8 * sq, dkv_err)):
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        res[name] = dict(ms=device_ms(torch, kernel, iters=10),
                         plain_ms=device_ms(torch, plain, iters=5),
                         library_ms=lib_ms,
                         call_ms=time_ms(torch, kernel, iters=10),
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         shape=f"B={b} H={h} Tl={t} Dh={d} bf16 unmasked",
                         **turns(torch, kernel, library))
        print(f"kernel {name} B={b} H={h} Tl={t} Dh={d} bf16 unmasked: "
              f"max_abs_err={err:.3g} (tol 2e-2; backward x max|plain|) "
              f"bitwise repeatable; library = SDPA is_causal=False"
              f"{' backward, both passes' if name != 'fa2_chunk_fwd' else ''}"
              "; " + " ".join(f"{k}={v:.5g}" for k, v in res[name].items()
                              if k in TIMED_MS) + "; " + turns_text(res[name]))
    return res


def gpt2_qkv(torch, port, model, seed):
    """Real gpt2-124m q/k/v: layer 0's qkv projection of a seeded batch,
    (B, H, T, Dh) bf16 each."""
    from tiny_deepspeed_tpu_torch.ops.layernorm import layernorm
    from tiny_deepspeed_tpu_torch.ops.linear import linear
    c = model.config
    idx, _ = port.TokenLoader(None, batch=RING_B, seq=RING_T,
                              vocab_size=c.vocab_size, seed=seed).next()
    with torch.no_grad():
        x = model.embed(torch.as_tensor(idx, device="cuda").long())
        bp = model._layer(model.stacked_compute_params(), 0)
        qkv = linear(layernorm(x, bp["ln_1.w"], bp["ln_1.b"]),
                     bp["attn.qkv.w"], bp["attn.qkv.b"])
    return [z.reshape(RING_B, RING_T, c.n_head, c.head_dim).transpose(1, 2)
            .contiguous() for z in qkv.split(c.n_embd, dim=-1)]


def ring_phase(torch, port, fa, counters, model):
    """7b: ring attention at full width over 4 virtual ranks on the card:
    four threads, one per rank, call ring_fwd / ring_bwd directly through
    a lockstep communicator.  The concatenated o, dq, dk, dv must match
    the full-sequence causal kernels at T=1024 (o atol = rtol = 2e-2;
    grads max abs err <= 2e-2 x max |full|), and the launches per
    attention call must be JAX's schedule: causal fwd/dq/dkv 4 each,
    unmasked 6 each."""
    from tiny_deepspeed_tpu_torch.parallel import ring_attention as ra
    q, k, v = gpt2_qkv(torch, port, model, seed=5)
    g = torch.Generator(device="cuda").manual_seed(6)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    o, lse = fa.fa2_flash_attention_fwd(q, k, v)
    di = (do.float() * o.float()).sum(-1)
    full = (o, fa.fa2_flash_attention_dq(q, k, v, do, lse, di),
            *fa.fa2_flash_attention_dkv(q, k, v, do, lse, di))
    torch.cuda.synchronize()

    def chunk(z, r):
        return z[:, :, r * RING_TL:(r + 1) * RING_TL].contiguous()

    def rank(r, comm):
        args = [chunk(z, r) for z in (q, k, v)]
        ro, rlse = ra.ring_fwd(*args, comm)
        return (ro, *ra.ring_bwd((*args, ro, rlse), chunk(do, r), comm))

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = ra.run_lockstep(RING_N, rank)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    ring = [torch.cat([r[i] for r in out], dim=2) for i in range(4)]
    torch.testing.assert_close(ring[0].float(), full[0].float(), atol=2e-2,
                               rtol=2e-2)
    errs = {n: _rel_err(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"),
                                                   ring, full)}
    check(all(r <= 2e-2 for _, r in list(errs.values())[1:]),
          f"ring gradients disagree with the full causal kernels: {errs}")
    want = {"fa2_flash_attention_fwd": 4, "fa2_flash_attention_dq": 4,
            "fa2_flash_attention_dkv": 4, "fa2_chunk_fwd": 6,
            "fa2_chunk_dq": 6, "fa2_chunk_dkv": 6}
    check({k: launches[k] for k in want} == want
          and not any(v for k, v in launches.items() if k not in want),
          f"ring launches {launches}, want {want}")
    print(f"  ring attention, 4 virtual ranks on one card (B={RING_B} "
          f"H={RING_H} T={RING_T} Tl={RING_TL} Dh={RING_D} bf16, gpt2-124m "
          f"layer-0 q/k/v): vs the full-sequence causal kernels "
          + ", ".join(f"{n} max_abs_err={e:.3g} ({r:.3g} of max|full|)"
                      for n, (e, r) in errs.items())
          + f" (tol 2e-2); forward+backward wall {wall * 1e3:.2f} ms "
          f"(threads in lockstep, not a multi-card time)")
    print(f"  launches per attention call (4 ranks): "
          f"{ {k: launches[k] for k in want} } = JAX's schedule")
    return launches


@contextlib.contextmanager
def nccl_world1(torch):
    """A one-rank NCCL process group (a file:// store under OUT_DIR) for
    phases 7c and 8c-8d; destroyed on the way out."""
    import torch.distributed as dist
    store = os.path.join(OUT_DIR, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    print(f"  process group: nccl, world 1; torch.cuda.device_count() "
          f"{torch.cuda.device_count()}; nccl {torch.cuda.nccl.version()}")
    try:
        yield
    finally:
        dist.destroy_process_group()


def engine_run(torch, port, counters, name, cfg, b=8, t=1024, warm=3,
               timed=10, lr=1e-5, profile=True, whole=True,
               need=TRAIN_KERNELS):
    """`name`'s engine on `cfg` with AdamW(lr, weight_decay=0.1) over the
    synthetic stream (seed 0): `warm` steps, then `timed` steps with every
    count zeroed just before and read just after; one profiled step's
    NCCL and memcpy time.  Returns its numbers, the losses of every step
    and, with `whole`, the whole params after them (`gather_params`)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = port.build_model(cfg)
    eng = getattr(port, name)(model, port.AdamW(lr=lr, weight_decay=0.1))
    state = eng.init(0)
    loader = port.TokenLoader(None, batch=b, seq=t,
                              vocab_size=cfg.vocab_size, seed=0)
    losses = []
    for _ in range(warm):
        state, loss = eng.step(state, loader.next())
        losses.append(float(loss))
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(timed):
        batch = loader.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = eng.step(state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    for k in need:
        check(launches[k] > 0, f"{name}: {k} never launched")
    check_ln_bwd_launches(launches, cfg, timed, name)
    check(all(math.isfinite(x) for x in losses), f"{name}: losses {losses}")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params = eng.gather_params(state) if whole else None
    out = dict(launches=launches, step_ms=med * 1e3, peak_gib=peak,
               tokens_per_s=b * t / med, losses=losses, params=params,
               describe=eng.describe(), engine=eng, state=state,
               loader=loader, med=med)
    if profile:
        def one_step():
            float(eng.step(state, loader.next())[1])

        prof = profiled(torch, one_step)
        check(prof is not None, "the profiler recorded no device time")
        # NCCL's kernels; at world 1 it may copy instead (memcpy)
        per, busy, rows = kernel_shares(torch, prof, {"nccl": "nccl",
                                                      "memcpy": "Memcpy"})
        check_no_pair_records(rows, f"{name}'s profiled step")
        out.update(nccl_ms=per.get("nccl", 0.0) / 1e3,
                   copy_ms=per.get("memcpy", 0.0) / 1e3, busy_ms=busy / 1e3)
    return out


def _free(run):
    for k in ("engine", "state", "params", "loader"):
        run.pop(k, None)


def engines_phase(torch, port, counters, train):
    """7c: DDP, Zero1 and Zero2 at world size 1 over NCCL train gpt2-124m
    with phase 4's config: the 13 steps' losses and params must equal
    SingleDevice's (phase 4) bit for bit; step time, tokens/s and peak
    memory beside phase 4's; one profiled step's NCCL time."""
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    out = {}
    for name in ("DDP", "Zero1", "Zero2"):
        run = engine_run(torch, port, counters, name, cfg)
        check(not any(run["launches"][k] for k in CHUNK_KERNELS),
              f"{name} at seq 1 ran a chunk kernel")
        same = run["losses"] == train["losses13"] and all(
            torch.equal(p, train["params13"][n])
            for n, p in run["params"].items())
        check(same, f"{name} at world 1 differs from SingleDevice: "
              f"losses {run['losses']} vs {train['losses13']}")
        print(f"  {run['describe']}: 13 steps bit-identical to "
              f"SingleDevice (losses and params); step time median "
              f"{run['step_ms']:.3f} ms -> {run['tokens_per_s']:.1f} "
              f"tokens/s (phase 4: {train['step_ms']:.3f} ms, "
              f"{train['tokens_per_s']:.1f}); peak memory "
              f"{run['peak_gib']:.2f} GiB (phase 4: {train['peak_gib']:.2f}); "
              f"one profiled step: NCCL kernels {run['nccl_ms']:.4f} ms, "
              f"memcpy {run['copy_ms']:.4f} ms, of {run['busy_ms']:.3f} ms "
              f"device busy")
        _free(run)
        out[name.lower()] = run
    return out


# -- phase 8: ZeRO-3, the fp8 gather and heads-last FA2 ----------------------

BTHD_KERNELS = ("fa2_flash_attention_bthd_fwd", "fa2_flash_attention_bthd_dq",
                "fa2_flash_attention_bthd_dkv")
# the A/B's shape (tiny_deepspeed_tpu_torch/fa2_bthd_ab.py), and phase 4's B
BTHD_H, BTHD_T, BTHD_D = 12, 1024, 64


def bthd_phase(torch, F, fa):
    """8a: the heads-last kernels (#7 fwd, #8 dq and dk/dv) at the A/B's
    shape (B=12 H=12 T=1024 Dh=64 bf16) and at phase 4's B=8: o, dq, dk,
    dv against their plain versions (o atol = rtol = 2e-2, lse 2e-3;
    grads max abs err <= 2e-2 x max |plain|), bit for bit #4 / #6 / #5 on
    the transposed contiguous copies (the JAX package's own contract,
    tests/test_flash_fa2.py:109-131), repeatable; device times beside the
    bound, the plain version and SDPA causal on the `.transpose(1, 2)`
    views (forward; forward+backward for the two backward rows)."""
    res = {}
    h, t, d = BTHD_H, BTHD_T, BTHD_D
    for b in (12, 8):
        g = torch.Generator(device="cuda").manual_seed(80 + b)
        q, k, v, do = (torch.randn(b, t, h, d, generator=g, device="cuda"
                                   ).bfloat16() for _ in range(4))
        o, lse = fa.fa2_flash_attention_bthd_fwd(q, k, v)
        di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = fa.fa2_flash_attention_bthd_dq(q, k, v, do, lse, di)
        dk, dv = fa.fa2_flash_attention_bthd_dkv(q, k, v, do, lse, di)
        torch.cuda.synchronize()
        po, plse = fa._fa2_bthd_fwd_plain(q, k, v)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)
        fwd_err = max_err(o, po)
        del po, plse
        pdq = fa._fa2_bthd_dq_plain(q, k, v, do, lse, di)
        dq_err, dq_rel = _rel_err(dq, pdq)
        del pdq
        pdk, pdv = fa._fa2_bthd_dkv_plain(q, k, v, do, lse, di)
        kv = [_rel_err(dk, pdk), _rel_err(dv, pdv)]
        del pdk, pdv
        dkv_err, dkv_rel = max(e for e, _ in kv), max(r for _, r in kv)
        check(dq_rel <= 2e-2 and dkv_rel <= 2e-2,
              f"bthd backward B={b} disagrees with its plain version: dq "
              f"rel {dq_rel:.3g}, dk/dv rel {dkv_rel:.3g}")
        # bit for bit the (B, H, T, Dh) kernels on transposed copies
        tr = [z.transpose(1, 2).contiguous() for z in (q, k, v, do)]
        ro, rlse = fa.fa2_flash_attention_fwd(*tr[:3])
        rdq = fa.fa2_flash_attention_dq(*tr, rlse, di)
        rdk, rdv = fa.fa2_flash_attention_dkv(*tr, rlse, di)
        torch.cuda.synchronize()
        same = torch.equal(lse, rlse) and all(
            torch.equal(a, r.transpose(1, 2))
            for a, r in zip((o, dq, dk, dv), (ro, rdq, rdk, rdv)))
        check(same, f"bthd kernels B={b} are not bit-identical to #4-#6 on "
              "the transposed copies")
        del tr, ro, rlse, rdq, rdk, rdv
        _bitwise(torch, lambda: fa.fa2_flash_attention_bthd_fwd(q, k, v),
                 "bthd fwd")
        _bitwise(torch, lambda: [fa.fa2_flash_attention_bthd_dq(
            q, k, v, do, lse, di)], "bthd dq")
        _bitwise(torch, lambda: fa.fa2_flash_attention_bthd_dkv(
            q, k, v, do, lse, di), "bthd dkv")

        # the yardsticks: SDPA causal on the (B, H, T, Dh) views
        qv, kv_, vv = (z.transpose(1, 2) for z in (q, k, v))
        def lib_fwd_fn():
            return F.scaled_dot_product_attention(qv, kv_, vv, is_causal=True)

        lib_fwd = device_ms(torch, lib_fwd_fn)
        qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))

        def lib_fb():
            out = F.scaled_dot_product_attention(
                qr.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2),
                is_causal=True)
            return torch.autograd.grad(out, (qr, kr, vr), do.transpose(1, 2))

        lib_fb_ms = device_ms(torch, lib_fb, iters=10)
        panel = b * h * t * d * 2
        stats = b * h * t * 4
        tri = d * t * (t + 1) / 2 * b * h
        for name, kernel, plain, library, lib, nbytes, flops, err in (
                ("fa2_flash_attention_bthd_fwd",
                 lambda: fa.fa2_flash_attention_bthd_fwd(q, k, v),
                 lambda: fa._fa2_bthd_fwd_plain(q, k, v), lib_fwd_fn,
                 lib_fwd, 4 * panel + stats, 4 * tri, fwd_err),
                ("fa2_flash_attention_bthd_dq",
                 lambda: fa.fa2_flash_attention_bthd_dq(q, k, v, do, lse, di),
                 lambda: fa._fa2_bthd_dq_plain(q, k, v, do, lse, di),
                 lib_fb, lib_fb_ms, 5 * panel + 2 * stats, 6 * tri, dq_err),
                ("fa2_flash_attention_bthd_dkv",
                 lambda: fa.fa2_flash_attention_bthd_dkv(q, k, v, do, lse,
                                                         di),
                 lambda: fa._fa2_bthd_dkv_plain(q, k, v, do, lse, di),
                 lib_fb, lib_fb_ms, 6 * panel + 2 * stats, 8 * tri,
                 dkv_err)):
            bms, by = bound_ms(nbytes, flops, "bfloat16")
            res[name, b] = dict(
                ms=device_ms(torch, kernel, iters=5),
                plain_ms=device_ms(torch, plain, iters=3),
                library_ms=lib, call_ms=time_ms(torch, kernel, iters=5),
                bound_ms=bms, bound_by=by, max_abs_err=err,
                shape=f"B={b} T={t} H={h} Dh={d} bf16 heads-last",
                **turns(torch, kernel, library, n=10))
            print(f"kernel {name} B={b} T={t} H={h} Dh={d} bf16: "
                  f"max_abs_err={err:.3g} (tol 2e-2; backward x max|plain|)"
                  f" bit-identical to the (B, H, T, Dh) kernel on the "
                  f"transposed copies, bitwise repeatable; library = SDPA "
                  f"causal on the transposed views"
                  f"{', forward+backward' if 'fwd' not in name else ''}; "
                  + " ".join(f"{k}={v:.5g}" for k, v in res[name, b].items()
                             if k in TIMED_MS) + "; "
                  + turns_text(res[name, b]))
        del q, k, v, do, o, lse, di, dq, dk, dv, qr, kr, vr
        torch.cuda.empty_cache()
    return res


def ab_phase(torch, counters):
    """8b: the A/B entry point (`python -m tiny_deepspeed_tpu_torch.
    fa2_bthd_ab`), both arms through the module at its shape: fb_ms, and
    the launches of the run — the heads-last kernels' main path (`ab`)."""
    from tiny_deepspeed_tpu_torch import fa2_bthd_ab
    for fn in counters.values():
        fn.launches = 0
    rows = fa2_bthd_ab.run("cuda")
    launches = {k: fn.launches for k, fn in counters.items()}
    fb = {r["arm"]: r["fb_ms"] for r in rows}
    print(f"  A/B (B=12 H=12 T=1024 Dh=64 bf16, f+b of sum(o^2), median of "
          f"{rows[0]['iters']} calls, CUDA events): transpose+fa2 "
          f"{fb['transpose+fa2']:.4f} ms, bthd_fa2 {fb['bthd_fa2']:.4f} ms "
          f"(bthd / transpose {fb['bthd_fa2'] / fb['transpose+fa2']:.4f})")
    print(f"  launches of the A/B run: "
          f"{ {k: v for k, v in launches.items() if v} }")
    for k in BTHD_KERNELS + FA2_TRAIN:
        check(launches[k] > 0, f"the A/B never launched {k}")
    return dict(launches=launches, fb_ms=fb)


def zero3_phase(torch, port, counters, train):
    """8c: Zero3 at world 1 over NCCL on gpt2-124m with phase 4's config:
    13 steps' losses and params bit-identical to phase 4's SingleDevice;
    then the fp8 gather (gather_quant="fp8"), SingleDevice and Zero3 bit
    for bit alike and within 5% of the unquantized losses at every step
    (JAX's criterion, tests/test_fp8_gather.py); step time, tokens/s, peak
    memory and one profiled step's NCCL / memcpy time of each."""
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    out = {}
    run = engine_run(torch, port, counters, "Zero3", cfg)
    same = run["losses"] == train["losses13"] and all(
        torch.equal(p, train["params13"][n])
        for n, p in run["params"].items())
    check(same, f"Zero3 at world 1 differs from SingleDevice: losses "
          f"{run['losses']} vs {train['losses13']}")
    check("params sharded=True" in run["describe"], run["describe"])
    print(f"  {run['describe']}: 13 steps bit-identical to SingleDevice "
          f"(losses and params); step time median {run['step_ms']:.3f} ms "
          f"-> {run['tokens_per_s']:.1f} tokens/s (phase 4: "
          f"{train['step_ms']:.3f} ms); peak memory {run['peak_gib']:.2f} "
          f"GiB (phase 4: {train['peak_gib']:.2f}); one profiled step: NCCL "
          f"kernels {run['nccl_ms']:.4f} ms, memcpy {run['copy_ms']:.4f} ms "
          f"of {run['busy_ms']:.3f} ms device busy")
    _free(run)
    out["zero3"] = run
    fp8 = dataclasses.replace(cfg, gather_quant="fp8")
    single = engine_run(torch, port, counters, "SingleDevice", fp8,
                        profile=False)
    single_losses, single_params = single["losses"], single["params"]
    single_ms = single["step_ms"]
    _free(single)
    run = engine_run(torch, port, counters, "Zero3", fp8)
    same = run["losses"] == single_losses and all(
        torch.equal(p, single_params[n]) for n, p in run["params"].items())
    check(same, f"fp8 Zero3 at world 1 differs from fp8 SingleDevice: "
          f"{run['losses']} vs {single_losses}")
    rel = [abs(a - b) / a for a, b in zip(train["losses13"], run["losses"])]
    check(max(rel) < 0.05, f"fp8 losses {max(rel):.4f} from bf16's")
    print(f"  gather_quant=fp8: SingleDevice and Zero3 13 steps "
          f"bit-identical (losses and params); losses within "
          f"{max(rel):.3g} of the unquantized run's (tol 0.05); Zero3 step "
          f"time median {run['step_ms']:.3f} ms -> "
          f"{run['tokens_per_s']:.1f} tokens/s (SingleDevice fp8 "
          f"{single_ms:.3f} ms); peak memory {run['peak_gib']:.2f} GiB; "
          f"one profiled step: NCCL kernels {run['nccl_ms']:.4f} ms, memcpy "
          f"{run['copy_ms']:.4f} ms of {run['busy_ms']:.3f} ms device busy")
    del single_params
    _free(run)
    out["zero3_fp8"] = run
    return out


def _zero3_rank_gib(model, data, cd_bytes=2):
    """What one rank holds of ZeRO-3's training state at `data` ranks,
    from the shard layout (parallel/zero3.py), not measured: per leaf the
    rank's shard of the f32 master, its gradient and AdamW's m and v (16
    bytes an element) plus the step's compute-dtype cast of the block
    shards; the non-block leaves gathered whole for the step (f32, and
    their whole gradient before its reduce-scatter); one layer's block
    weights gathered whole in the compute dtype (forward or recompute)
    and their gradient."""
    state = stacked = whole = layer = 0
    for name, shape in model.param_shapes().items():
        n = math.prod(shape[1:] if name.startswith("h.") else shape)
        own = -(-n // data)
        rows = shape[0] if name.startswith("h.") else 1
        state += 16 * own * rows
        if name.startswith("h."):
            stacked += cd_bytes * own * rows
            layer += 2 * cd_bytes * n
        else:
            whole += 8 * n
    return (state + stacked + whole + layer) / 2 ** 30


def zero3_xl_phase(torch, port, counters):
    """8d: Zero3 trains gpt2-1.5b (examples/zero3's default model: 48
    layers, 25 heads, n_embd 1600) at full width and depth, world 1 over
    NCCL, B=8 T=1024 (B=4 if the peak passes 70 GB): 3 warm-up and 5
    timed steps, the first loss in [10.5, 11.2]; median step time,
    tokens/s, peak memory, one profiled step's busy / idle and kernel
    classes, and what a rank would hold at data 4 and 8."""
    cfg = port.GPT2_PRESETS["gpt2-1.5b"]
    b, t = 8, 1024
    run = engine_run(torch, port, counters, "Zero3", cfg, b=b, t=t, warm=3,
                     timed=5, profile=False, whole=False)
    if run["peak_gib"] * 2 ** 30 > 70e9:
        print(f"  B=8 peaked at {run['peak_gib']:.2f} GiB > 70 GB: B=4")
        _free(run)
        b = 4
        run = engine_run(torch, port, counters, "Zero3", cfg, b=b, t=t,
                         warm=3, timed=5, profile=False, whole=False)
    losses = run["losses"]
    check(10.5 <= losses[0] <= 11.2,
          f"gpt2-1.5b first loss {losses[0]} outside [10.5, 11.2]")
    model = run["engine"].model
    print(f"  {run['describe']}; gpt2-1.5b {model.num_params() / 1e6:.1f}M "
          f"params, remat={cfg.remat} policy={cfg.remat_policy}, B={b} "
          f"T={t}")
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  step time median {run['step_ms']:.3f} ms -> "
          f"{run['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{run['peak_gib']:.2f} GiB")
    pats = {**PATTERNS, "nccl": "nccl", "memcpy": "Memcpy"}
    step_ms, busy, gemm, other = step_profile(
        torch, run["engine"], run["state"], run["loader"].next(),
        "zero3_1.5b_profile.txt", TRAIN_KERNELS + ("nccl", "memcpy"),
        run["med"], patterns=pats)
    per_rank = {d: _zero3_rank_gib(model, d) for d in (1, 4, 8)}
    act = run["peak_gib"] - per_rank[1]
    print(f"  per-rank ZeRO-3 state from the shard layout (not measured): "
          + ", ".join(f"data {d}: {g:.2f} GiB" for d, g in per_rank.items())
          + f"; the measured peak less the data-1 state, {act:.2f} GiB "
          f"(activations, logits, workspace), stays per rank at B={b}: "
          f"data 4 ~{per_rank[4] + act:.2f} GiB, data 8 "
          f"~{per_rank[8] + act:.2f} GiB a rank")
    out = dict(launches=run["launches"], step_ms=run["step_ms"],
               tokens_per_s=run["tokens_per_s"], peak_gib=run["peak_gib"],
               busy_ms=busy / 1e3, batch=b, kernel_ms_per_step=step_ms,
               per_rank_gib=per_rank, first_loss=losses[0])
    _free(run)
    return out


# -- phase 9: the Llama family ------------------------------------------------

LLAMA = "llama-160m"
# rows r1, r1r, r2+3, r2+3r: RMSNorm on the LayerNorm entries' RMS flag
# (csrc/ln_fwd.cu `rms_fwd`, csrc/ln_bwd.cu `rms_bwd`); r2+3 counts every
# RMS backward launch, r2+3r those that added a gs
RMS_KERNELS = ("rmsnorm_fwd", "add_rmsnorm_fwd", "rmsnorm_bwd",
               "rmsnorm_bwd_gs")
# 9a's shapes: llama-160m's decode tick (8 rows), a prefill (512), the
# training step (8192) of 768, and llama-1b's width (8192 x 2048), bf16;
# f32 and f16 at 768
RMS_CASES = ((8, 768, "bfloat16"), (512, 768, "bfloat16"),
             (8192, 768, "bfloat16"), (8192, 2048, "bfloat16"),
             (8, 768, "float32"), (512, 768, "float32"),
             (8, 768, "float16"), (512, 768, "float16"))
RMS_TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-5}
# the kernels each Llama serving path must launch, and nothing else
LLAMA_BASE = ("rmsnorm_fwd", "add_rmsnorm_fwd", "fa2_flash_attention_fwd",
              "kv_write")
LLAMA_PATHS = {
    "llama_serving": LLAMA_BASE + ("paged_attention",
                                   "paged_attention_append"),
    "llama_spec_ngram": LLAMA_BASE + ("paged_attention_span",),
    "llama_quant_int8": LLAMA_BASE + ("paged_attention_quant",
                                      "paged_attention_append"),
    "llama_prefix_on": LLAMA_BASE + ("paged_attention",
                                     "paged_attention_span",
                                     "paged_attention_append"),
}
LLAMA_TRAIN = ("rmsnorm_fwd", "add_rmsnorm_fwd", "rmsnorm_bwd",
               "rmsnorm_bwd_gs", "fa2_flash_attention_fwd",
               "fa2_flash_attention_dq", "fa2_flash_attention_dkv")
LLAMA_PATTERNS = {"rmsnorm_fwd": "rms_fwd_", "add_rmsnorm_fwd": "add_rms_fwd_",
                  "rmsnorm_bwd": "rms_bwd_",
                  "fa2_flash_attention_fwd": "flash_fwd_",
                  "fa2_flash_attention_dq": "flash_dq_",
                  "fa2_flash_attention_dkv": "flash_dkv_",
                  "kv_write": "kv_write_kernel",
                  "paged_attention": "paged_decode_kernel",
                  "paged_attention_span": "paged_span_",
                  "layernorm": "ln_fwd_"}


def _rms_inputs(torch, rows, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r, gy, gs = ((torch.randn(rows, n, generator=g, device="cuda") * 2
                     + 0.3).to(dtype) for _ in range(4))
    w = (1 + 0.3 * torch.randn(n, generator=g, device="cuda")).to(dtype)
    return x, r, gy, gs, w


def _rms_sides(torch, F, rn, x, r, gy, gs, w):
    """{row: (kernel, plain version, library call, bytes, flops)}: the
    bytes each function must move (inputs read once, outputs written
    once; ln_bwd's f32 partials are its own) and its operations."""
    rows, n = x.shape
    e = x.element_size()
    rstd = rn._rms_fwd_plain(x, w)[1]
    xg = x.detach().clone().requires_grad_()
    wg = w.detach().clone().requires_grad_()
    yl = F.rms_norm(xg, (n,), wg, 1e-5)

    def lib_bwd():
        return torch.autograd.grad(yl, (xg, wg), gy, retain_graph=True)

    def lib_bwd_gs():
        dx, dw = lib_bwd()
        return gs + dx, dw

    io = rows * n * e
    return {
        "rmsnorm_fwd": (lambda: rn.rmsnorm_fwd(x, w),
                        lambda: rn._rms_fwd_plain(x, w),
                        lambda: F.rms_norm(x, (n,), w, 1e-5),
                        2 * io + n * e + rows * 4, 4 * rows * n),
        "add_rmsnorm_fwd": (lambda: rn.add_rmsnorm_fwd(x, r, w),
                            lambda: rn._add_rms_fwd_plain(x, r, w),
                            lambda: F.rms_norm(x + r, (n,), w, 1e-5),
                            4 * io + n * e + rows * 4, 5 * rows * n),
        "rmsnorm_bwd": (lambda: rn.rmsnorm_bwd(gy, x, w, rstd),
                        lambda: rn._rms_bwd_plain(gy, x, w, rstd),
                        lib_bwd, 3 * io + 2 * n * e + rows * 4,
                        8 * rows * n),
        "rmsnorm_bwd_gs": (lambda: rn.rmsnorm_bwd(gy, x, w, rstd, gs),
                           lambda: rn._rms_bwd_plain(gy, x, w, rstd, gs),
                           lib_bwd_gs, 4 * io + 2 * n * e + rows * 4,
                           9 * rows * n),
    }


def rms_phase(torch, F, rn):
    """9a: the RMS entries against their plain versions at RMS_CASES (y /
    dx within RMS_TOL of the row scale, dw of the column sums', rstd 1e-5;
    the add's s bit for bit `x + r`, the gs variant bit for bit `gs + dx`;
    each call twice, bit for bit), then timed in bf16 at 8192 x 768 (the
    training step: the rows' shape) beside the bound, the plain version
    and the library call (F.rms_norm; `x + r` first; its autograd
    backward; `gs + dx` after), kernel and library in turns; at 8 x 768
    (the decode tick) the forwards' device time and every row's host ms
    a call; at 8192 x 2048 each kernel in turns with the library call."""
    errs = {k: 0.0 for k in RMS_KERNELS}
    dw_errs = {k: 0.0 for k in RMS_KERNELS[2:]}
    for i, (rows, n, dt) in enumerate(RMS_CASES):
        dtype = getattr(torch, dt)
        x, r, gy, gs, w = _rms_inputs(torch, rows, n, dtype, 40 + i)
        for name, (kern, plain, *_) in _rms_sides(torch, F, rn, x, r, gy, gs,
                                                  w).items():
            got, again, ref = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"9a: {name} at {rows}x{n} {dt} not bit for bit on a "
                  "repeat")
            if name == "add_rmsnorm_fwd":
                check(torch.equal(got[0], x + r), "9a: add_rmsnorm_fwd's s "
                      "is not x + r")
            out, want = got[-2], ref[-2]  # y, or dx
            scale = float(want.float().abs().max()) + 1.0
            e = max_err(out, want)
            check(e <= RMS_TOL[dt] * scale,
                  f"9a: {name} at {rows}x{n} {dt}: max_abs_err {e:.4g} > "
                  f"{RMS_TOL[dt]} x {scale:.4g}")
            errs[name] = max(errs[name], e)
            if name.startswith("rmsnorm_bwd"):
                sc = float(ref[1].float().abs().max()) + 1.0
                ew = max_err(got[1], ref[1])
                check(ew <= RMS_TOL[dt] * sc, f"9a: {name} dw at {rows}x{n} "
                      f"{dt}: max_abs_err {ew:.4g} > {RMS_TOL[dt]} x {sc:.4g}")
                dw_errs[name] = max(dw_errs[name], ew)
            else:
                e = max_err(got[-1], ref[-1])
                check(e <= 1e-5 * (float(ref[-1].abs().max()) + 1.0),
                      f"9a: {name} rstd at {rows}x{n} {dt}: {e:.4g}")
        dx0 = rn.rmsnorm_bwd(gy, x, w, rn._rms_fwd_plain(x, w)[1])[0]
        dxg = rn.rmsnorm_bwd(gy, x, w, rn._rms_fwd_plain(x, w)[1], gs)[0]
        check(torch.equal(dxg, gs + dx0), f"9a: the gs variant at {rows}x{n}"
              f" {dt} is not gs + dx")
    print(f"  RMS entries vs plain at {len(RMS_CASES)} shapes (bf16 8/512/"
          f"8192 x 768, 8192 x 2048; f32, f16 8/512 x 768): max_abs_err "
          f"y/dx { {k: float(f'{v:.4g}') for k, v in errs.items()} }, dw "
          f"{ {k: float(f'{v:.4g}') for k, v in dw_errs.items()} } (tol "
          "2e-2 bf16/f16, 1e-5 f32, x the output's scale); repeats bit for "
          "bit; s = x + r and dx_gs = gs + dx bit for bit")
    res = {}
    for rows, n in ((8192, 768), (8, 768), (8192, 2048)):
        x, r, gy, gs, w = _rms_inputs(torch, rows, n, torch.bfloat16, 7)
        for name, (kern, plain, lib, nbytes, flops) in _rms_sides(
                torch, F, rn, x, r, gy, gs, w).items():
            if n == 2048:  # CUDA events, kernel and library in turns
                t = turns(torch, kern, lib, reps=3)
                t.update(ms=Ms(t["turns_ms"], "events"),
                         library_ms=Ms(t["library_turns_ms"], "events"))
            elif rows == 8:  # the decode tick's: host ms a call
                t = dict(call_ms=time_ms(torch, kern))
                if not name.startswith("rmsnorm_bwd"):
                    t["ms"] = device_ms(torch, kern)
            else:
                t = timings(torch, kern, plain, lib)
                t.update(turns(torch, kern, lib))
            b, by = bound_ms(nbytes, flops, "bfloat16")
            t.update(shape=f"{rows}x{n} bf16", bound_ms=b, bound_by=by,
                     max_abs_err=errs[name])
            for k in ("ms", "plain_ms", "library_ms", "call_ms"):
                t.setdefault(k, None)
            res[name, rows, n] = t
            print(f"  {name} {rows}x{n} bf16: "
                  + (f"{t['ms']:.5g} ms device ({t['ms'].source})"
                     if t["ms"] is not None else "device -")
                  + f", bound {b:.5g} ms ({by}), plain "
                  + (f"{t['plain_ms']:.5g}" if t["plain_ms"] is not None
                     else "-") + ", library "
                  + (f"{t['library_ms']:.5g}" if t["library_ms"] is not None
                     else "-")
                  + (f", host {t['call_ms']:.5g} ms a call"
                     if t["call_ms"] is not None else "")
                  + (f"; {turns_text(t)}" if "turns_ms" in t else ""))
    return res


def llama_plain_ops(rn):
    """The RMS entries swapped for their plain versions (the autograd
    Functions look them up at call time)."""
    return swapped((rn, "rmsnorm_fwd", rn._rms_fwd_plain),
                   (rn, "add_rmsnorm_fwd", rn._add_rms_fwd_plain),
                   (rn, "rmsnorm_bwd", rn._rms_bwd_plain))


def _llama_launch_check(launches, want, where):
    for k in want:
        check(launches[k] > 0, f"{where}: {k} was never launched")
    quiet = {k: v for k, v in launches.items() if k not in want and v}
    check(not quiet, f"{where} ran kernels outside its path: {quiet}")


def rope_swiglu_launches(torch, F, model):
    """Kernel launches a decode tick spends on RoPE (the tick's tables
    once, then q and k rotated in one pass a layer) and on SwiGLU's
    elementwise part (silu, the product), at llama-160m's tick shapes (8
    slots), and on gpt2-124m's GELU for comparison: each piece called
    once under a dispatch mode that counts the aten ops that launch a
    kernel on the card (views launch none).  Counted at the dispatcher:
    late in a run the profiler's CUPTI traces come back empty or short."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Launches(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tree_leaves(out)):
                self.n += 1
            return out

    def count(fn):
        with Launches() as mode:
            fn()
        return mode.n

    c = model.config
    g = torch.Generator(device="cuda").manual_seed(5)
    pos = torch.randint(16, 600, (8,), device="cuda", generator=g)
    bp = model._layer(model.stacked_compute_params(), 0)
    h = torch.randn(8, 1, c.n_embd, device="cuda", generator=g).to(
        c.compute_dtype)
    gate, up = (torch.randn(8, 1, c.ffn, device="cuda", generator=g).to(
        c.compute_dtype) for _ in range(2))
    with torch.no_grad():
        q, k, _ = model._qkv(h, bp)
        rot = model._rot(pos[:, None])
        tables = count(lambda: model._rot(pos[:, None]))
        qk = count(lambda: model._rope_qk(q, k, rot))
        swi = count(lambda: F.silu(gate) * up)
        gelu = count(lambda: F.gelu(gate, approximate="tanh"))
    return dict(rope=tables + c.n_layer * qk, rope_tables=tables,
                rope_qk_layer=qk, swiglu=c.n_layer * swi,
                swiglu_layer=swi, gpt2_gelu=c.n_layer * gelu)


def llama_serving_phase(torch, np, port, counters, pa, pool_mod, qm, rn,
                        gpt2_tick):
    """9b: llama-160m (bf16, seeded random weights) served through
    ServingEngine: phase 3's traffic, then 8 requests under spec-ngram,
    an int8 pool and the prefix cache; the prefill's and first decode
    step's logits against the plain path; an f32 pass whose plain and
    spec-ngram tokens must be identical; a profiled pass; the decode tick
    alone."""
    cfg = port.LLAMA_PRESETS[LLAMA]
    model = port.LlamaModel(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    print(f"  llama-160m: {model.num_params() / 1e6:.1f}M params, "
          f"{cfg.n_layer} layers, {cfg.n_head} query heads over "
          f"{cfg.kv_heads} kv heads, Dh {cfg.head_dim}, SwiGLU {cfg.ffn}")
    prompts, new = serving_traffic(np)
    serve(torch, port, model, [prompts[0][:24], prompts[1][:40]], 4)  # warm
    for fn in counters.values():
        fn.launches = 0
    eng, reqs, wall, seg, _ = serve(torch, port, model, prompts, new)
    launches = {k: fn.launches for k, fn in counters.items()}
    paths = {"llama_serving": launches}
    print(f"  launches on the main path: "
          f"{ {k: v for k, v in launches.items() if v} }")
    _llama_launch_check(launches, LLAMA_PATHS["llama_serving"],
                        "phase 9b (llama serving)")
    check(launches["paged_attention_append"] == launches["paged_attention"]
          and launches["kv_write"] == seg["prefills"],
          f"9b: appends {launches['paged_attention_append']} against "
          f"{launches['paged_attention']} decode launches, kv_write "
          f"{launches['kv_write']} against {seg['prefills']} prefills")
    check(all(r.status == "ok" for r in reqs), f"9b statuses "
          f"{[r.status for r in reqs]}")
    check(all(len(r.tokens) == new for r in reqs)
          and all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "9b: short token streams or ids out of range")
    check(eng.pool.blocks_in_use == 0 and eng.restarts == 0,
          "9b: pool blocks leaked or a warm restart")
    total = sum(len(r.tokens) for r in reqs)
    ttft = statistics.median(r.t_first - r.t_arrival for r in reqs)
    out = dict(wall_s=wall, decode_tok_s=(total - len(reqs))
               / seg["decode_s"], ttft_p50_ms=ttft * 1e3,
               prefill_s=seg["prefill_s"], decode_s=seg["decode_s"],
               ticks=seg["decode_ticks"])
    print(f"  16 requests ok, {total} tokens in {wall:.4f}s; decode "
          f"{total - len(reqs)} tokens in {seg['decode_ticks']} ticks, "
          f"{seg['decode_s']:.4f}s -> {out['decode_tok_s']:.2f} decode "
          f"tok/s; prefill {seg['prefill_s']:.4f}s; TTFT p50 "
          f"{ttft * 1e3:.2f} ms (all 16 submitted at t=0)")
    del eng

    def _both_plain():
        stack = contextlib.ExitStack()
        stack.enter_context(plain_serving_ops(pa, pool_mod, qm))
        stack.enter_context(llama_plain_ops(rn))
        return stack

    kern, ref = plain_prefill_logits(torch, port, model, prompts[0],
                                     extra=llama_plain_ops(rn))
    (_, kd), (_, rd) = quant_prefill_check(torch, model, prompts[0], None,
                                           _both_plain, counters)
    for what, a, b in (("prefill", kern, ref), ("first decode step", kd,
                                                 rd)):
        e, sc = max_err(a, b), float(b.abs().max())
        print(f"  {what} logits vs the plain path on the card: "
              f"max_abs_err={e:.4g}, max|logit|={sc:.4g} (tol 5e-2 x "
              f"max|logit|); argmax {int(a.argmax())} / {int(b.argmax())}")
        check(bool(torch.isfinite(a).all()) and e <= 5e-2 * sc,
              f"9b: the {what} logits disagree with the plain path")
        out[what.replace(" ", "_") + "_err"] = e

    pprompts, pnew = prefix_traffic(np)
    for name, ps, nw, knobs in (
            ("llama_spec_ngram", prompts[:8], new,
             dict(spec_draft="ngram", spec_k=4)),
            ("llama_quant_int8", prompts[:8], new, dict(quant="int8")),
            ("llama_prefix_on", pprompts[:8], pnew,
             dict(prefix_cache=True))):
        serve_variant(torch, model, [ps[0][:24], ps[1][:300]], 4, counters,
                      **knobs)  # warm
        veng, vreqs, vwall, vseg, vl, _, _ = serve_variant(
            torch, model, ps, nw, counters, **knobs)
        paths[name] = vl
        _llama_launch_check(vl, LLAMA_PATHS[name], f"9b ({name})")
        check(all(r.status == "ok" and len(r.tokens) == nw for r in vreqs),
              f"9b ({name}): statuses {[r.status for r in vreqs]}")
        held = len(set(veng._prefix.blocks())) if veng._prefix else 0
        check(veng.pool.blocks_in_use == held and veng.restarts == 0,
              f"9b ({name}): pool blocks leaked or a warm restart")
        vt = sum(len(r.tokens) for r in vreqs)
        st = ""
        if veng._spec is not None:
            st = (f"; acceptance {veng._spec_accepted}/"
                  f"{veng._spec_proposed}")
        if veng._prefix is not None:
            ps_ = veng.prefix_stats()
            check(ps_["blocks_aliased"] > 0, "9b: the prefix run aliased "
                  "nothing")
            st = f"; aliased blocks {ps_['blocks_aliased']}"
        out[name] = dict(wall_s=vwall, decode_tok_s=(vt - len(vreqs))
                         / vseg["decode_s"], ttft_p50_ms=statistics.median(
                             r.t_first - r.t_arrival for r in vreqs) * 1e3)
        print(f"  {name}: 8 requests ok, {vt} tokens in {vwall:.4f}s, "
              f"{out[name]['decode_tok_s']:.2f} decode tok/s, TTFT p50 "
              f"{out[name]['ttft_p50_ms']:.2f} ms{st}; launches "
              f"{ {k: v for k, v in vl.items() if v} }")
        del veng
    torch.cuda.empty_cache()

    m32 = port.LlamaModel(dataclasses.replace(cfg,
                                              compute_dtype=torch.float32))
    m32.load_state_dict(model.state_dict())
    toks = {}
    for name, knobs in (("plain", {}), ("spec_ngram",
                                        dict(spec_draft="ngram", spec_k=4))):
        _, rq, *_ = serve_variant(torch, m32, prompts[:8], 32, counters,
                                  **knobs)
        check(all(r.status == "ok" for r in rq), f"9b f32 {name} failed")
        toks[name] = [r.tokens for r in rq]
    print(f"  f32 llama-160m, 8 requests x 32 tokens: plain == spec-ngram: "
          f"{toks['plain'] == toks['spec_ngram']}")
    check(toks["plain"] == toks["spec_ngram"], "9b: f32 spec-ngram tokens "
          f"differ from plain greedy ({_agree(toks['plain'], toks['spec_ngram'])})")
    del m32
    torch.cuda.empty_cache()

    for _ in range(3):  # an empty CUPTI trace: serve the traffic again
        *_, prof = serve(torch, port, model, prompts, new, profile=True)
        if prof is not None:
            break
    check(prof is not None, "9b: the profiler recorded no device time")
    per, busy, rows = kernel_shares(torch, prof, LLAMA_PATTERNS)
    check(per.get("layernorm", 0.0) == 0.0, "9b: a LayerNorm kernel ran")
    with open(os.path.join(OUT_DIR, "llama_serving_profile.txt"), "w") as f:
        for us, n, key in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    out.update(busy_s=busy / 1e6, idle_share=1 - busy / 1e6 / wall,
               kernel_s={k: v / 1e6 for k, v in per.items()})
    print(f"  device busy {busy / 1e6:.4f}s of the main run's {wall:.4f}s "
          f"wall (idle share {out['idle_share']:.4f}); kernel device s "
          f"{ {k: round(v / 1e6, 5) for k, v in per.items()} }")
    for us, n, key in rows[:8]:
        print(f"    {us / 1e3:10.3f} ms x{n:<6d} {key[:90]}")
    del prof
    tick = tick_report(torch, model, prompts, counters, pool_mod,
                       "phase 9 (llama-160m, bf16 pool)", arms=("fused",))
    rs = rope_swiglu_launches(torch, torch.nn.functional, model)
    out.update(tick=tick["fused"], rope_swiglu=rs)
    print(f"  decode tick device kernels: llama-160m "
          f"{tick['fused']['kernels']:.2f} (launches: RoPE {rs['rope']}, "
          f"tables {rs['rope_tables']} once + {rs['rope_qk_layer']} a "
          f"layer; SwiGLU's silu and product {rs['swiglu']}), gpt2-124m "
          f"(phase 3) {gpt2_tick['kernels']:.2f} (GELU {rs['gpt2_gelu']}); "
          "busy "
          f"{tick['fused']['busy_ms']:.4f} vs {gpt2_tick['busy_ms']:.4f} ms,"
          f" host {tick['fused']['host_ms']:.4f} vs "
          f"{gpt2_tick['host_ms']:.4f} ms a tick")
    del model
    torch.cuda.empty_cache()
    return paths, out


def llama_train_phase(torch, port, counters, rn, ln, fa, fx, af):
    """9c: llama-160m through SingleDevice + AdamW(lr=1e-5, wd=0.1) at B=8
    T=1024 on the synthetic stream: 3 warm-up and 10 timed steps, the
    first loss in [10.5, 11.2], the RMS backward's launches, one profiled
    step, one step's gradients against the plain path (rel L2 <= 5e-2 a
    leaf), remat on and off bit for bit (wte: the CUDA embedding
    backward's rounding), 8 steps on one batch at lr 1e-3."""
    b, t = 8, 1024
    cfg = port.LLAMA_PRESETS[LLAMA]
    torch.cuda.reset_peak_memory_stats()
    model = port.LlamaModel(cfg)
    eng = port.SingleDevice(model, port.AdamW(lr=1e-5, weight_decay=0.1))
    state = eng.init(0)
    loader = port.TokenLoader(None, batch=b, seq=t,
                              vocab_size=cfg.vocab_size, seed=0)
    print(f"  {eng.describe()}; {LLAMA} {model.num_params() / 1e6:.1f}M "
          f"params, remat={cfg.remat} policy={cfg.remat_policy}, B={b} "
          f"T={t}")
    losses = []
    for _ in range(3):
        state, loss = eng.step(state, loader.next())
        losses.append(float(loss))
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(10):
        batch = loader.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = eng.step(state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  launches on the main path (10 steps): "
          f"{ {k: v for k, v in launches.items() if v} }")
    _llama_launch_check(launches, LLAMA_TRAIN, "phase 9c (llama training)")
    check(launches["rmsnorm_bwd"] == (2 * cfg.n_layer + 1) * 10
          and launches["rmsnorm_bwd_gs"] == cfg.n_layer * 10,
          f"9c: rmsnorm_bwd {launches['rmsnorm_bwd']} (gs "
          f"{launches['rmsnorm_bwd_gs']}), want {(2 * cfg.n_layer + 1) * 10}"
          f" ({cfg.n_layer * 10})")
    check(all(math.isfinite(x) for x in losses), f"9c losses {losses}")
    check(10.5 <= losses[0] <= 11.2,
          f"9c: first loss {losses[0]} outside [10.5, 11.2]")
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  step time median {med * 1e3:.3f} ms (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) -> "
          f"{b * t / med:.1f} tokens/s; peak memory {peak:.2f} GiB")
    kernels = ("rmsnorm_fwd", "add_rmsnorm_fwd", "rmsnorm_bwd",
               "fa2_flash_attention_fwd", "fa2_flash_attention_dq",
               "fa2_flash_attention_dkv")
    step_ms, busy, gemm, other = step_profile(
        torch, eng, state, loader.next(), "llama_train_profile.txt", kernels,
        med, patterns={k: LLAMA_PATTERNS[k] for k in kernels})

    batch = loader.next()
    kl, kg = loss_and_grads(torch, model, batch)
    before = {k: fn.launches for k, fn in counters.items()}
    with plain_ops(ln, fa, fx, af), llama_plain_ops(rn):
        pl, pg = loss_and_grads(torch, model, batch)
    check({k: fn.launches for k, fn in counters.items()} == before,
          "9c: the plain path launched a kernel")
    rel = {n: float((kg[n].float() - pg[n].float()).norm()
                    / pg[n].float().norm().clamp_min(1e-30)) for n in kg}
    worst = max(rel, key=rel.get)
    print(f"  gradients kernel vs plain path: loss {kl:.6f} vs {pl:.6f} "
          f"(tol 1e-2); worst leaf {worst} rel L2 err {rel[worst]:.4g} "
          "(tol 5e-2)")
    check(abs(kl - pl) <= 1e-2 and rel[worst] <= 5e-2,
          "9c: the gradients disagree with the plain path")
    model.config = dataclasses.replace(cfg, remat=False)
    try:
        ol, og = loss_and_grads(torch, model, batch)
    finally:
        model.config = cfg
    differ = [n for n in kg if n != "wte" and not torch.equal(kg[n], og[n])]
    wte_rel = float((kg["wte"] - og["wte"]).norm()
                    / og["wte"].norm().clamp_min(1e-30))
    print(f"  remat on vs off: loss {kl!r} vs {ol!r}; {len(kg) - 1} leaves "
          f"bit-identical: {not differ}; wte rel L2 {wte_rel:.3g}")
    check(kl == ol and not differ and wte_rel <= 1e-5,
          f"9c: remat changed the gradients: {differ}")
    del kg, pg, og
    eng2 = port.SingleDevice(model, port.AdamW(lr=1e-3, weight_decay=0.1))
    state2 = eng2.init(1)
    fixed = loader.next()
    fit = []
    for _ in range(8):
        state2, loss = eng2.step(state2, fixed)
        fit.append(float(loss))
    print(f"  8 steps at lr=1e-3 on one batch: {[round(x, 4) for x in fit]}")
    check(all(math.isfinite(x) for x in fit) and fit[-1] < fit[0],
          "9c: the loss did not fall on a fixed batch")
    del model, eng, state, eng2, state2
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=med * 1e3,
                tokens_per_s=b * t / med, peak_gib=peak, busy_ms=busy / 1e3,
                idle_share=1 - busy / 1e6 / med, gemm_ms=gemm / 1e3,
                other_ms=other / 1e3, kernel_ms_per_step=step_ms,
                first_loss=losses[0], fit=fit)


# -- phase 10: the MoE family ------------------------------------------------

MOE = "moe-8x124m"
# phase 4's launches in 10 steps of each training kernel: moe-8x124m's
# blocks norm and attend as gpt2-124m's
MOE_TRAIN = {"layernorm_fwd": 250, "add_layernorm_fwd": 240,
             "layernorm_bwd": 250, "fa2_flash_attention_fwd": 240,
             "fa2_flash_attention_dq": 120, "fa2_flash_attention_dkv": 120}
# the profiler ranges `moe_ranges` opens (also device-side annotations:
# spans, not kernels)
MOE_RANGES = ("moe_route", "moe_mlp", "moe_experts")


@contextlib.contextmanager
def moe_routing(model, picks, own=None):
    """The model's expert choices, call by call: recorded into `picks`
    (own None), or forced to `picks` in call order — its own choices then
    appended to `own`, its gates taken from its own probabilities at the
    forced experts (the router's formula).  bf16 LayerNorm and attention
    outputs round apart between the kernel and plain paths, which flips a
    token's choice where two probabilities nearly tie and reorders the
    capacity's drops; forced, the plain path routes as the kernel path
    did."""
    cls = type(model)

    def router(x, w):
        gate, idx, probs = cls._router(model, x, w)
        if own is None:
            picks.append(idx)
            return gate, idx, probs
        own.append(idx)
        idx = picks[len(own) - 1]
        gate = probs.gather(1, idx)
        return gate / (gate.sum(-1, keepdim=True) + 1e-9), idx, probs

    model._router = router
    try:
        yield
    finally:
        del model._router


@contextlib.contextmanager
def moe_ranges(torch, model, drops=None):
    """The model's routing (`_route` / `_route_sort`), MoE MLP and experts
    each inside a profiler range (instance attributes, removed on the way
    out); with `drops`, each routing call appends the (token, choice)
    pairs capacity dropped (the einsum table's missing ones, the sort
    path's dump entries)."""
    from torch.profiler import record_function
    cls, k = type(model), model.config.expert_top_k

    def ranged(label, fn, count=None):
        def call(*a, **kw):
            with record_function(label):
                out = fn(model, *a, **kw)
            if count is not None and drops is not None:
                drops.append(count(a[0], out))
            return out
        return call

    model._route = ranged("moe_route", cls._route, lambda x, out: (
        x.shape[0] * k - int(out[0].sum(dtype=torch.float32))))
    model._route_sort = ranged("moe_route", cls._route_sort,
                               lambda x, out: int((out[3] == out[0].numel())
                                                  .sum()))
    model._moe_mlp = ranged("moe_mlp", cls._moe_mlp)
    model._expert_ffn = ranged("moe_experts", cls._expert_ffn)
    try:
        yield
    finally:
        for name in ("_route", "_route_sort", "_moe_mlp", "_expert_ffn"):
            delattr(model, name)


def moe_classes(torch, prof, slots):
    """Device us of a profiled MoE step by class, from each CPU op's own
    kernels: the experts' batched products (`aten::bmm`, forward,
    recompute and backward), the dispatch (the einsum path's products
    with an E*C = `slots` side; the sort path's slot gathers and gated
    sums: the MoE MLP's range and SlotRows' backward), the routing tables
    (the routing's range, also in the recompute); the rest is busy minus
    these."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {"routing": 0.0, "dispatch": 0.0, "experts": 0.0}
    for e in prof.events():
        if (e.device_type == cuda or not e.self_device_time_total
                or e.name in MOE_RANGES):
            continue
        shapes = e.input_shapes or []
        if e.name == "aten::bmm":
            cls = "experts"
        elif e.name == "aten::mm" and any(slots in (s or ()) for s in shapes):
            cls = "dispatch"
        else:
            cls, p = None, e.cpu_parent
            while p is not None and cls is None:
                if p.name == "moe_route":
                    cls = "routing"
                elif p.name == "moe_experts":
                    break
                elif p.name == "moe_mlp" or "SlotRows" in p.name:
                    cls = "dispatch"
                p = p.cpu_parent
        if cls is not None:
            out[cls] += e.self_device_time_total
    return out


def moe_step_profile(torch, model, eng, state, batch, name, med):
    """One profiled step (CPU ops with shapes, CUDA kernels) under
    `moe_ranges`: busy, idle share, cuBLAS GEMMs and the device ms by
    class (`moe_classes`); the table to build/chip_smoke/`name`."""
    from torch.profiler import ProfilerActivity, profile
    c = model.config
    slots = c.n_expert * max(1, int(c.capacity_factor * c.expert_top_k
                                    * batch[0].size / c.n_expert))
    for _ in range(3):  # an empty CUPTI trace: step again
        with moe_ranges(torch, model), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            float(eng.step(state, batch)[1])
            torch.cuda.synchronize()
        per, busy, rows = kernel_shares(torch, prof, PATTERNS)
        busy -= sum(us for us, _, key in rows if key in MOE_RANGES)
        rows = [r for r in rows if r[2] not in MOE_RANGES]
        if busy > 0:
            break
    check(busy > 0, "the profiler recorded no device time")
    check_no_pair_records(rows, name)
    gemm = sum(us for us, _, key in rows
               if "gemm" in key.lower() or key.startswith("nvjet"))
    classes = {k: v / 1e3 for k, v in moe_classes(torch, prof, slots).items()}
    classes["rest"] = busy / 1e3 - sum(classes.values())
    with open(os.path.join(OUT_DIR, name), "w") as f:
        for us, n, key in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    print(f"  one profiled step: device busy {busy / 1e3:.3f} ms = "
          f"{busy / 1e3 / (med * 1e3):.4f} of the median step wall (idle "
          f"share {1 - busy / 1e6 / med:.4f}); cuBLAS GEMMs "
          f"{gemm / 1e3:.3f} ms; by class (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in classes.items()))
    for us, n, key in rows[:8]:
        print(f"    {us / 1e3:10.3f} ms x{n:<6d} {key[:90]}")
    return dict(busy_ms=busy / 1e3, idle_share=1 - busy / 1e6 / med,
                gemm_ms=gemm / 1e3, classes_ms=classes,
                kernel_ms_per_step={k: per.get(k, 0.0) / 1e3
                                    for k in MOE_TRAIN})


def moe_train_phase(torch, port, counters, ln, fa, fx, af):
    """10: moe-8x124m through SingleDevice + AdamW(lr=1e-5, wd=0.1) at B=8
    T=1024 on the synthetic stream, with each dispatch (see the module
    docstring)."""
    b, t = 8, 1024
    paths, res = {}, {}
    for disp in ("einsum", "sort"):
        cfg = dataclasses.replace(port.MOE_PRESETS[MOE], moe_dispatch=disp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = port.MoEGPT(cfg)
        eng = port.SingleDevice(model, port.AdamW(lr=1e-5, weight_decay=0.1))
        state = eng.init(0)
        loader = port.TokenLoader(None, batch=b, seq=t,
                                  vocab_size=cfg.vocab_size, seed=0)
        print(f"  {disp}: {eng.describe()}; {MOE} "
              f"{model.num_params() / 1e6:.1f}M params, remat={cfg.remat} "
              f"policy={cfg.remat_policy}, B={b} T={t}")
        drops = []
        with moe_ranges(torch, model, drops):
            state, loss = eng.step(state, loader.next())
        drops = drops[:cfg.n_layer]  # the forward's (then the recompute's)
        losses = [float(loss)]
        for _ in range(2):
            state, loss = eng.step(state, loader.next())
            losses.append(float(loss))
        for fn in counters.values():
            fn.launches = 0
        ln.layernorm_bwd.launches_gs = 0
        times = []
        for _ in range(10):
            batch = loader.next()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = eng.step(state, batch)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in counters.items()}
        with_gs = ln.layernorm_bwd.launches_gs
        got = {k: v for k, v in launches.items() if v}
        print(f"  launches on the main path (10 steps): {got}; "
              f"layernorm_bwd with gs (row 2+3r) {with_gs}")
        check(got == MOE_TRAIN and with_gs == 120,
              f"10 ({disp}): launches {got} (gs {with_gs}), want "
              f"{MOE_TRAIN} (gs 120)")
        check(all(math.isfinite(x) for x in losses), f"10 losses {losses}")
        check(10.5 <= losses[0] <= 11.2,
              f"10 ({disp}): first loss {losses[0]} outside [10.5, 11.2]")
        med = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        s_tok = b * t
        print(f"  losses {[round(x, 4) for x in losses]}")
        print(f"  first step: (token, choice) pairs dropped by capacity "
              f"{sum(drops)} of {s_tok * cfg.expert_top_k * cfg.n_layer} "
              f"(per layer {drops})")
        print(f"  step time median {med * 1e3:.3f} ms (min "
              f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) -> "
              f"{s_tok / med:.1f} tokens/s; peak memory {peak:.2f} GiB")
        prof = moe_step_profile(torch, model, eng, state, loader.next(),
                                f"moe_{disp}_profile.txt", med)

        batch = loader.next()
        picks, own = [], []
        with moe_routing(model, picks):
            kl, kg = loss_and_grads(torch, model, batch)
        before = {k: fn.launches for k, fn in counters.items()}
        with plain_ops(ln, fa, fx, af), moe_routing(model, picks, own):
            pl, pg = loss_and_grads(torch, model, batch)
        check({k: fn.launches for k, fn in counters.items()} == before,
              "10: the plain path launched a kernel")
        agree = min(float((a == b).all(-1).float().mean())
                    for a, b in zip(own, picks))
        rel = _leaf_rel(torch, kg, pg)
        worst = max(rel, key=rel.get)
        print(f"  gradients kernel vs plain path (routed as the kernel "
              f"path; its own choices agree on {agree:.4f} of the tokens "
              f"in the worst of {len(own)} router calls): loss {kl:.6f} vs "
              f"{pl:.6f} (tol 1e-2); worst leaf {worst} rel L2 err "
              f"{rel[worst]:.4g} (tol 5e-2)")
        check(len(own) == len(picks) and agree >= 0.9,
              f"10 ({disp}): the plain path routed {agree} alike")
        check(abs(kl - pl) <= 1e-2 and rel[worst] <= 5e-2,
              f"10 ({disp}): the gradients disagree with the plain path")
        del pg
        model.config = dataclasses.replace(cfg, remat=False)
        try:
            torch.cuda.reset_peak_memory_stats()
            ol, og = loss_and_grads(torch, model, batch)
            off_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            model.config = cfg
        differ = [n for n in kg
                  if n != "wte" and not torch.equal(kg[n], og[n])]
        wte_rel = _leaf_rel(torch, {"wte": kg["wte"]},
                            {"wte": og["wte"]})["wte"]
        print(f"  remat on vs off: loss {kl!r} vs {ol!r}; {len(kg) - 1} "
              f"leaves bit-identical: {not differ}; wte rel L2 "
              f"{wte_rel:.3g}; peak memory with remat off {off_peak:.2f} "
              "GiB")
        check(kl == ol and not differ and wte_rel <= 1e-5,
              f"10 ({disp}): remat changed the gradients: {differ}")
        del kg, og
        if disp == "sort":  # the other dispatch on the same weights
            with torch.no_grad():
                idx, tgt = (torch.as_tensor(a, device=model.device).long()
                            for a in batch)
                sl = float(model.apply(idx, tgt))
                model.config = dataclasses.replace(cfg,
                                                   moe_dispatch="einsum")
                try:
                    el = float(model.apply(idx, tgt))
                finally:
                    model.config = cfg
            print(f"  einsum vs sort on one batch, the same weights: loss "
                  f"{el!r} vs {sl!r} (tol 1e-2)")
            check(abs(el - sl) <= 1e-2, "10: einsum and sort disagree")
            res["einsum_vs_sort"] = (el, sl)
        paths[f"moe_{disp}_training"] = launches
        res[disp] = dict(step_ms=med * 1e3, tokens_per_s=s_tok / med,
                         layernorm_bwd_gs=with_gs,
                         peak_gib=peak, remat_off_peak_gib=off_peak,
                         first_loss=losses[0], losses=losses,
                         drops_first_step=drops, grad_rel_worst=rel[worst],
                         plain_routing_agreement=agree, **prof)
        del model, eng, state
        torch.cuda.empty_cache()
    return paths, res


def moe_engines_phase(torch, port, counters, steps=2):
    """7c / 8c for the MoE family (in their NCCL group): DDP and Zero3 at
    world 1 on moe-8x124m with phase 4's config (einsum) `steps` steps
    bit for bit SingleDevice's, and Zero3 with the fp8 gather bit for bit
    fp8 SingleDevice's.  Returns each path's launches."""
    base = port.MOE_PRESETS[MOE]
    paths = {}
    for quant, names in ((None, ("DDP", "Zero3")), ("fp8", ("Zero3",))):
        cfg = dataclasses.replace(base, gather_quant=quant)
        ref = engine_run(torch, port, counters, "SingleDevice", cfg, warm=0,
                         timed=steps, profile=False)
        want_losses, want = ref["losses"], ref["params"]
        _free(ref)
        for name in names:
            run = engine_run(torch, port, counters, name, cfg, warm=0,
                             timed=steps, profile=False)
            same = run["losses"] == want_losses and all(
                torch.equal(p, want[n]) for n, p in run["params"].items())
            what = f"{name}" + (" (fp8 gather)" if quant else "")
            check(same, f"MoE {what} at world 1 differs from SingleDevice: "
                  f"{run['losses']} vs {want_losses}")
            print(f"  {MOE} {what}: {steps} steps bit-identical to "
                  f"SingleDevice (losses {run['losses']} and params); step "
                  f"time median {run['step_ms']:.3f} ms; peak memory "
                  f"{run['peak_gib']:.2f} GiB")
            paths["moe_" + name.lower() + ("_fp8" if quant else "")] = \
                run["launches"]
            _free(run)
        del want
        torch.cuda.empty_cache()
    return paths


# -- phase 11: generate and checkpoints ----------------------------------------

# (launch path, preset): the generate paths of the `kernels` line
GEN_PATHS = (("gen", "gpt2-124m"), ("L-gen", "llama-160m"),
             ("M-gen", MOE))
GEN_B, GEN_T0, GEN_NEW = 8, 128, 128
# the plain versions the generate paths must never reach on the card:
# (module attribute, module name in `main`)
GEN_PLAIN = (("_paged_attention_plain", "pa"), ("_kv_write_plain", "pool"),
             ("_ln_fwd_plain", "ln"), ("_add_ln_fwd_plain", "ln"),
             ("_fa2_fwd_plain", "fa"), ("_rms_fwd_plain", "rn"),
             ("_add_rms_fwd_plain", "rn"))


def is_llama_path(p):
    return p.startswith("llama_") or p == "L-gen"


def gen_launches_want(cfg, new):
    """Each generate kernel's launches in one greedy call: the prefill's
    norms (ln_1 alone and ln_2 with its add a block, ln_f), one FA2
    forward a layer and one kv_write for every layer; each of the new - 1
    decode steps one decode launch (with its append) a layer, its first
    ln_1 and ln_f alone and 23 norms with their add."""
    n_l, steps = cfg.n_layer, new - 1
    return {"norm": n_l + 1 + 2 * steps,
            "add_norm": n_l + (2 * n_l - 1) * steps,
            "fa2_flash_attention_fwd": n_l, "kv_write": 1,
            "paged_attention": n_l * steps,
            "paged_attention_append": n_l * steps}


@contextlib.contextmanager
def counted_plain(mods, calls):
    """Every plain version in GEN_PLAIN wrapped to count its calls into
    `calls` (a run on the card must leave it empty)."""
    changes = []
    for attr, mod in GEN_PLAIN:
        m = mods[mod]
        fn = getattr(m, attr)

        def wrapped(*a, _fn=fn, _name=attr, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        changes.append((m, attr, wrapped))
    with swapped(*changes):
        yield


def gen_first_logits(model, prompt, tok=None):
    """The prefill's and the first decode step's logits, (B, V) f32 each,
    over a fresh private pool; the decode step takes `tok` when given
    (the plain path decodes the kernel path's token)."""
    b, t0 = prompt.shape
    cache = model._gen_cache(b, t0 + GEN_NEW)
    stacked = model.stacked_compute_params()
    hp = model.head_compute_params()
    l0 = model._prefill(prompt, cache, stacked, hp)
    tok = l0.argmax(-1) if tok is None else tok
    l1 = model._decode_step(tok, t0, cache, stacked, hp)
    return l0, l1, tok, (cache, stacked, hp)


def gen_logits_check(model, prompt, plain_ops, is_moe):
    """First decode step's logits, kernel path against the plain path on
    the card (5e-2 x max |logit|); the MoE plain path is handed the
    kernel path's expert choices (`moe_routing`)."""
    picks, own = [], []
    with (moe_routing(model, picks) if is_moe
          else contextlib.nullcontext()):
        k0, k1, tok, kept = gen_first_logits(model, prompt)
    with plain_ops(), (moe_routing(model, picks, own) if is_moe
                       else contextlib.nullcontext()):
        p0, p1, _, _ = gen_first_logits(model, prompt, tok)
    err0, err1 = max_err(k0, p0), max_err(k1, p1)
    scale0, scale1 = float(p0.abs().max()), float(p1.abs().max())
    agree = None
    if is_moe:
        agree = min(float((a == b).all(-1).float().mean())
                    for a, b in zip(picks, own))
    return {"prefill_err": err0, "prefill_scale": scale0,
            "decode_err": err1, "decode_scale": scale1,
            "argmax_agree": float((k1.argmax(-1) == p1.argmax(-1))
                                  .float().mean()),
            "moe_own_choices_agree_min": agree}, kept


def gen_plain_ops(pa, pool_mod, qm, rn):
    """Every kernel wrapper the generate paths reach swapped for its plain
    version: serving's (`plain_serving_ops`) and the RMS entries."""
    stack = contextlib.ExitStack()
    stack.enter_context(plain_serving_ops(pa, pool_mod, qm))
    stack.enter_context(llama_plain_ops(rn))
    return stack


def gen_phase(torch, np, port, counters, mods, plain_ops):
    """11a: generate on gpt2-124m, llama-160m and moe-8x124m (bf16, full
    width and depth, seeded random weights): B=8 rows of a 128-token
    seeded prompt, 128 new greedy tokens.  Counts zeroed just before the
    timed call and read just after: every decode step on 9a with its
    append, the prefill on #4, the norms and one kv_write, no plain
    version (each wrapped to count); prefill ms (the TTFT), decode
    tokens/s, one profiled decode step's busy and idle, peak memory; the
    first decode step's logits against the plain path."""
    paths, res = {}, {}
    rng = np.random.default_rng(11)
    for path, preset in GEN_PATHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = port.build_model(preset).init(
            torch.Generator(device="cuda").manual_seed(0))
        cfg = model.config
        prompt = torch.as_tensor(rng.integers(0, 50257, (GEN_B, GEN_T0)),
                                 device="cuda")
        model.generate(prompt[:, :16], 4, temperature=0.0)  # warm
        is_moe = preset == MOE
        check_res, kept = gen_logits_check(model, prompt, plain_ops,
                                           is_moe)
        seg = {}
        prefill = model._prefill

        def timed_prefill(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = prefill(*a)
            out.argmax(-1).cpu()  # the first token on the host: the TTFT
            seg["prefill_s"] = time.perf_counter() - t
            return out

        model._prefill = timed_prefill
        plain_calls = []
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted_plain(mods, plain_calls):
            out = model.generate(prompt, GEN_NEW, temperature=0.0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        del model._prefill
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        paths[path] = launches
        norm, add = (("rmsnorm_fwd", "add_rmsnorm_fwd") if path == "L-gen"
                     else ("layernorm_fwd", "add_layernorm_fwd"))
        want = gen_launches_want(cfg, GEN_NEW)
        got = {"norm": launches[norm], "add_norm": launches[add],
               **{k: launches[k] for k in want if k in launches}}
        check(got == want, f"11a {preset}: launches {got}, expected {want}")
        on_path = {norm, add, *[k for k in want if k in launches]}
        check(not any(v for k, v in launches.items() if k not in on_path),
              f"11a {preset}: a kernel off the generate path ran: "
              f"{ {k: v for k, v in launches.items() if v and k not in on_path} }")
        check(not plain_calls, f"11a {preset}: plain versions ran on the "
              f"card: {sorted(set(plain_calls))}")
        check(out.shape == (GEN_B, GEN_T0 + GEN_NEW)
              and torch.equal(out[:, :GEN_T0], prompt)
              and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              f"11a {preset}: output malformed")
        cr = check_res
        check(cr["prefill_err"] <= 5e-2 * cr["prefill_scale"]
              and cr["decode_err"] <= 5e-2 * cr["decode_scale"],
              f"11a {preset}: logits disagree with the plain path: {cr}")
        # one decode step, profiled, over the check's pool (position T0+1)
        cache, stacked, hp = kept
        tok = out[:, GEN_T0].contiguous()
        prof = profiled(torch, lambda: model._decode_step(
            tok, GEN_T0 + 1, cache, stacked, hp))
        check(prof is not None, "the profiler recorded no device time")
        _, busy, rows = kernel_shares(torch, prof, PATTERNS)
        with open(os.path.join(OUT_DIR, f"{path}_profile.txt"), "w") as f:
            for us, n, key in rows:
                f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
        ttft = seg["prefill_s"]
        decode_s = wall - ttft
        step_ms = decode_s / (GEN_NEW - 1) * 1e3
        r = {"preset": preset, "wall_s": wall, "prefill_ms": ttft * 1e3,
             "decode_s": decode_s, "decode_step_ms": step_ms,
             "decode_tok_s": GEN_B * (GEN_NEW - 1) / decode_s,
             "end_to_end_tok_s": GEN_B * GEN_NEW / wall,
             "profiled_step_busy_ms": busy / 1e3,
             "profiled_step_records": sum(n for _, n, _ in rows),
             "idle_share": 1 - busy / 1e3 / step_ms, "peak_gib": peak,
             "launches": got, **cr}
        res[path] = r
        print(f"  {path} {preset}: prefill (B={GEN_B} T0={GEN_T0}) "
              f"{r['prefill_ms']:.3f} ms (the TTFT); {GEN_NEW - 1} decode "
              f"steps {decode_s:.4f}s -> {r['decode_tok_s']:.2f} decode "
              f"tok/s ({step_ms:.4f} ms a step; end to end "
              f"{r['end_to_end_tok_s']:.2f} tok/s); one profiled step busy "
              f"{r['profiled_step_busy_ms']:.4f} ms, "
              f"{r['profiled_step_records']} records, idle share "
              f"{r['idle_share']:.4f}; peak {peak:.2f} GiB")
        print(f"    launches {got} (= expected; plain versions 0; 9a "
              f"appends {launches['paged_attention_append']}); logits vs "
              f"plain: prefill {cr['prefill_err']:.4g} (max|logit| "
              f"{cr['prefill_scale']:.4g}), first decode step "
              f"{cr['decode_err']:.4g} ({cr['decode_scale']:.4g}), tol "
              f"5e-2 x max|logit|; argmax agree {cr['argmax_agree']:.3f}"
              + ("" if not is_moe else f"; the plain path's own choices "
                 f"agree on >= {cr['moe_own_choices_agree_min']:.3f} of "
                 "the tokens a router call"))
        for us, n, key in rows[:6]:
            print(f"      {us / 1e3:9.4f} ms x{n:<4d} {key[:80]}")
        if path == "gen":
            res["f32"] = gen_f32_identity(torch, port, model, prompt)
        del model, cache, stacked, hp, kept, prof
        torch.cuda.empty_cache()
    return paths, res


def gen_f32_identity(torch, port, model, prompt):
    """gpt2-124m in f32 (the same weights): greedy `generate` equal to the
    port's ServingEngine on the same 8 prompts (32 new tokens), and the
    cached path to the uncached one over 8 tokens."""
    cfg = dataclasses.replace(model.config, compute_dtype=torch.float32)
    m32 = port.GPT2Model(cfg)
    m32.load_state_dict(model.state_dict())
    new = 32
    out = m32.generate(prompt, new, temperature=0.0)
    from tiny_deepspeed_tpu_torch.serving import ServeConfig, ServingEngine
    per = -(-(GEN_T0 + new) // 16) + 1
    eng = ServingEngine(m32, ServeConfig(max_active=GEN_B, block_tokens=16,
                                         num_blocks=GEN_B * per))
    reqs = [eng.submit(p, new) for p in prompt.tolist()]
    eng.drain(max_ticks=10_000)
    check(all(r.status == "ok" for r in reqs), "11a f32: serving failed")
    served = [r.tokens for r in reqs]
    mine = out[:, GEN_T0:].tolist()
    same = mine == served
    cached = m32.generate(prompt, 8, temperature=0.0)
    uncached = m32.generate(prompt, 8, temperature=0.0, use_cache=False)
    same_uc = torch.equal(cached, uncached)
    agree = sum(a == b for x, y in zip(mine, served) for a, b in zip(x, y))
    print(f"  f32 gpt2-124m: generate == ServingEngine over 8 prompts x "
          f"{new} tokens: {same} ({agree} of {GEN_B * new} tokens agree); "
          f"cached == uncached over 8 tokens: {same_uc}")
    check(same, "11a f32: generate's greedy tokens differ from the "
          "serving engine's")
    check(same_uc, "11a f32: cached generate differs from uncached")
    del m32, eng
    torch.cuda.empty_cache()
    return {"same_as_serving": same, "cached_equals_uncached": same_uc}


def ckpt_run(torch, port, engine_cls, batches, ckpt_dir=None, **kw):
    """Phase 4's config on `engine_cls`: the 6 steps straight (ckpt_dir
    None), or 3 steps, save, a fresh model and engine loaded from the
    checkpoint (no init drawn), 3 steps.  Returns (losses, whole params,
    whole optimizer state, save s, load s, bytes)."""
    from tiny_deepspeed_tpu_torch.utils import checkpoint as ck
    cfg = port.GPT2_PRESETS["gpt2-124m"]

    def engine():
        return engine_cls(port.GPT2Model(cfg),
                          port.AdamW(lr=1e-5, weight_decay=0.1), **kw)

    eng = engine()
    state = eng.init(0)
    losses, save_s, load_s, nbytes = [], None, None, None
    for i, batch in enumerate(batches):
        if ckpt_dir is not None and i == 3:
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = ck.save_checkpoint(ckpt_dir, state, 3)
            save_s = time.perf_counter() - t
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            del eng, state
            torch.cuda.empty_cache()
            eng = engine()
            t = time.perf_counter()
            state = ck.load_checkpoint(ckpt_dir, eng)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
        state, loss = eng.step(state, batch)
        losses.append(float(loss))
    opt = eng.gather_opt_state(state)
    params = eng.gather_params(state)
    del eng, state
    torch.cuda.empty_cache()
    return losses, params, opt, save_s, load_s, nbytes


def _same_state(torch, a, b):
    """Bit for bit: params, the optimizer's step and every slot."""
    if a[2]["step"] != b[2]["step"]:
        return False
    return all(torch.equal(a[1][n], b[1][n]) for n in a[1]) and all(
        torch.equal(a[2]["state"][n][k], b[2]["state"][n][k])
        for n in a[2]["state"] for k in a[2]["state"][n])


def ckpt_phase(torch, port, phase4_losses):
    """11b: phase 4's config (gpt2-124m, SingleDevice + AdamW(1e-5, wd
    0.1), B=8 T=1024, the synthetic stream seed 0): 6 steps straight
    (phase 4's first 6 losses, bit for bit, when given),
    then 3 + save + load + 3 under SingleDevice and under world-1 Zero3
    (NCCL), each bit for bit the straight 6 — losses, params, the
    optimizer's moments and step — in a temp dir under build/chip_smoke/
    that the phase removes; save and load seconds and bytes."""
    import shutil
    import tempfile
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    loader = port.TokenLoader(None, batch=8, seq=1024,
                              vocab_size=cfg.vocab_size, seed=0)
    batches = [loader.next() for _ in range(6)]
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=OUT_DIR)
    try:
        straight = ckpt_run(torch, port, port.SingleDevice, batches)
        check(phase4_losses is None or straight[0] == phase4_losses,
              f"11b: the straight 6 steps {straight[0]} differ from phase "
              f"4's {phase4_losses}")
        out = {"single": ckpt_run(torch, port, port.SingleDevice, batches,
                                  os.path.join(tmp, "single"))}
        shutil.rmtree(os.path.join(tmp, "single"))
        with nccl_world1(torch):
            out["zero3"] = ckpt_run(torch, port, port.Zero3, batches,
                                    os.path.join(tmp, "zero3"))
        res = {"losses": straight[0]}
        for name in ("single", "zero3"):
            r = out[name]
            same = r[0] == straight[0] and _same_state(torch, r, straight)
            res[name] = {"bitwise": same, "losses": r[0], "save_s": r[3],
                         "load_s": r[4], "bytes": r[5]}
            print(f"  {name}: 3 steps + save ({r[3]:.3f} s, {r[5]} bytes) "
                  f"+ load ({r[4]:.3f} s) + 3 steps bit for bit the "
                  f"straight 6 (losses, params, moments, step): {same}")
            check(same, f"11b {name}: the resumed run differs from the "
                  f"straight one: {r[0]} vs {straight[0]}")
        print(f"  the straight 6 losses {[round(x, 4) for x in straight[0]]}"
              " (= phase 4's first 6)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), "11b: the temp dir was not removed")
    return res



# -- phase 12: the in-step collective schedule (parallel/schedule.py) -------

SCHED_ENGINES = (("sched_ddp_b4", "DDP", dict(grad_buckets=4), None),
                 ("sched_zero3_p2", "Zero3", dict(gather_prefetch=2), None),
                 ("sched_zero3_p2_b4_fp8", "Zero3",
                  dict(gather_prefetch=2, grad_buckets=4), "fp8"))
# gpt2-124m: one block's params, and its bytes in bf16
LAYER_PARAMS = 7_087_872


def _sched_steps(torch, port, name, cfg, n=3, b=8, t=1024, **kw):
    """`name` on `cfg` as engine_run builds it, `n` steps: (losses, whole
    params, engine, the construction's warnings)."""
    torch.cuda.empty_cache()
    model = port.build_model(cfg)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = getattr(port, name)(model, port.AdamW(lr=1e-5,
                                                    weight_decay=0.1), **kw)
    state = eng.init(0)
    loader = port.TokenLoader(None, batch=b, seq=t,
                              vocab_size=cfg.vocab_size, seed=0)
    losses = [float(eng.step(state, loader.next())[1]) for _ in range(n)]
    return losses, eng.gather_params(state), eng, [str(x.message) for x in w]


def sched_engines_phase(torch, port, counters, train, z3_fp8_losses, card):
    """12a: each knob set through its engine at world 1 — inert, with
    JAX's warning, the plain path bit for bit."""
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    refs = {}
    for gq in (None, "fp8"):
        losses, params, _, _ = _sched_steps(
            torch, port, "SingleDevice",
            dataclasses.replace(cfg, gather_quant=gq))
        refs[gq] = (losses, params)
    check(refs[None][0] == train["losses13"][:3],
          f"12a: SingleDevice's 3 losses {refs[None][0]} are not phase 4's "
          f"{train['losses13'][:3]}")
    check(refs["fp8"][0] == z3_fp8_losses[:3],
          f"12a: fp8 SingleDevice's losses {refs['fp8'][0]} are not phase "
          f"8c's {z3_fp8_losses[:3]}")
    paths = {}
    for path, name, kw, gq in SCHED_ENGINES:
        for fn in counters.values():
            fn.launches = 0
        losses, params, eng, warns = _sched_steps(
            torch, port, name, dataclasses.replace(cfg, gather_quant=gq),
            **kw)
        paths[path] = {k: fn.launches for k, fn in counters.items()}
        for k in TRAIN_KERNELS:
            check(paths[path][k] > 0, f"12a {path}: {k} never launched")
        slots = [w for w in warns if "inert on a 1-device data axis" in w]
        check(len(slots) == 1 + ("grad_buckets" in kw and
                                 "gather_prefetch" in kw),
              f"12a {path}: warnings {warns}")
        check(eng._schedule.lowering == "plain", f"12a {path}: lowering "
              f"{eng._schedule.lowering}")
        want_l, want_p = refs[gq]
        check(losses == want_l and all(torch.equal(p, want_p[n])
                                       for n, p in params.items()),
              f"12a {path}: losses {losses} vs {want_l} or params differ")
        print(f"  [{card}] 12a {name}({kw}{', fp8' if gq else ''}): "
              f"{'; '.join(w.split(';')[0] for w in slots)}; lowering "
              f"plain; 3 steps bit for bit SingleDevice's "
              f"({'phase 8c fp8' if gq else 'phase 4'}): losses {losses}")
        del eng, params
    return paths


def _trace_overlap(torch, fn):
    """One profiled call of fn: (the share of the device time of the
    collectives — every record on a stream other than the one that runs
    the most kernel time — that overlaps a kernel on that compute stream,
    the collectives' ms, the compute stream's kernel ms, their names)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(OUT_DIR, "sched_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f).get("traceEvents", [])
        dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")
               and "dur" in e]
        if dev:
            break
    else:
        return None
    by = {}
    for e in dev:
        if e["cat"] == "kernel":
            by[e["args"].get("stream")] = by.get(
                e["args"].get("stream"), 0.0) + e["dur"]
    main = max(by, key=by.get)
    comp = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev
                  if e["cat"] == "kernel" and e["args"].get("stream") == main)
    merged = []
    for a, b in comp:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    side = [e for e in dev if e["args"].get("stream") != main]
    total = sum(e["dur"] for e in side)
    over = 0.0
    for e in side:
        a, b = e["ts"], e["ts"] + e["dur"]
        over += sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)
    names = sorted({e["name"][:40] for e in side})
    return (over / total if total else 0.0, total / 1e3,
            sum(y - x for x, y in merged) / 1e3, names)


def _pass_turns(torch, arms, reps=3):
    """Each arm's forward + backward wall ms, the median of `reps` taken
    in turns (reported, not claimed)."""
    times = {a: [] for a in arms}
    for _ in range(reps):
        for a, fn in arms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[a].append((time.perf_counter() - t0) * 1e3)
    return {a: statistics.median(v) for a, v in times.items()}


def _grads_equal(torch, got, want, what):
    bad = [n for n, g in want.items() if not torch.equal(got[n], g)]
    check(not bad, f"12b {what}: gradients differ from the on-demand "
          f"path's on {bad}")


def sched_exec_phase(torch, port, counters, card):
    """12b: the executors built directly at world 1 over the one-rank
    group, one forward and backward of phase 4's batch each."""
    from tiny_deepspeed_tpu_torch.parallel import schedule as S
    from tiny_deepspeed_tpu_torch.parallel.zero3 import LayerGather
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    L = cfg.n_layer
    layer_bytes = LAYER_PARAMS * 2
    batch = port.TokenLoader(None, batch=8, seq=1024,
                             vocab_size=cfg.vocab_size, seed=0).next()
    torch.cuda.empty_cache()
    z3 = port.Zero3(port.build_model(cfg), port.AdamW(lr=1e-5))
    zs = z3.init(0)
    idx, tg = (z3._local(a) for a in batch)
    zp = zs.params
    out, paths = {}, {}

    def z3_pass(exe=None):
        kw = {} if exe is None else {"sched": exe}
        loss = z3.model.apply(idx, tg, pctx=z3.pctx, params=zp, **kw)
        g = torch.autograd.grad(loss / z3.pctx.world, list(zp.values()))
        return loss.detach(), dict(zip(zp, g))

    def composed_pass(exe):
        z3._exec = exe
        try:
            return z3._composed(zp, idx, tg, None)[:2]
        finally:
            z3._exec = None

    want_loss, want = z3_pass()
    arms = {"on-demand": lambda: z3_pass()}
    for k in (2, 3):
        exe = S.ScanExecutor(z3, "prefetch", k - 1, None,
                             LayerGather(z3._z3))
        for fn in counters.values():
            fn.launches = 0
        loss, got = z3_pass(exe)
        paths[f"exec_prefetch{k}"] = {n: fn.launches
                                      for n, fn in counters.items()}
        check(torch.equal(loss, want_loss), f"12b prefetch K={k}: loss")
        _grads_equal(torch, got, want, f"prefetch K={k}")
        check(exe._lb_bytes == layer_bytes,
              f"12b: a layer's gathered bytes {exe._lb_bytes}")
        check(exe.live.peak <= k * layer_bytes and exe.live.now == 0,
              f"12b prefetch K={k}: peak {exe.live.peak} bytes > {k} layers")
        out[f"prefetch{k}"] = {"peak_bytes": exe.live.peak,
                               "k_layers_bytes": k * layer_bytes}
        arms[f"prefetch K={k}"] = (lambda e=exe: z3_pass(e))
    exe = S.ScanExecutor(z3, "composed", 0, L // 4, LayerGather(z3._z3))
    for fn in counters.values():
        fn.launches = 0
    loss, got = composed_pass(exe)
    paths["exec_composed_b4"] = {n: fn.launches for n, fn in counters.items()}
    check(torch.equal(loss, want_loss), "12b composed: loss")
    _grads_equal(torch, got, want, "composed, 4 buckets")
    out["composed_b4"] = {"peak_bytes": exe.live.peak,
                          "k_layers_bytes": layer_bytes}
    arms["composed 4 buckets"] = (lambda e=exe: composed_pass(e))
    ov = {}
    for name in ("prefetch K=2", "composed 4 buckets"):
        res = _trace_overlap(torch, arms[name])
        check(res is not None, f"12b {name}: the trace has no device record")
        ov[name] = res
    med = _pass_turns(torch, arms)
    del arms, z3, zs, zp, want, got, exe
    torch.cuda.empty_cache()

    ddp = port.DDP(port.build_model(cfg), port.AdamW(lr=1e-5))
    ds = ddp.init(0)
    dp = ds.params
    didx, dtg = (ddp._local(a) for a in batch)
    tail = [n for n in dp if not n.startswith("h.")]
    cd = cfg.compute_dtype

    def ddp_pass():
        loss, g = ddp._loss_and_grads(dp, didx, dtg, None, None)[:2]
        return loss, ddp._reduce(g)

    def bucket_pass(k):
        rel = S.BucketRelease(ddp, n_buckets=k)
        loss = ddp.model.apply(didx, dtg, params=dp, sched=rel)
        g = torch.autograd.grad(loss, [dp[n] for n in tail] + [rel.anchor])
        grads = ddp._release_tail(dict(zip(tail, g)), tail, None)[0]
        grads.update(rel.finish(dp))
        return loss.detach(), grads

    dwant_loss, dwant = ddp_pass()
    arms = {"DDP plain": ddp_pass}
    for k in (4, 12):
        for fn in counters.values():
            fn.launches = 0
        loss, got = bucket_pass(k)
        paths[f"exec_bucket{k}"] = {n: fn.launches
                                    for n, fn in counters.items()}
        check(torch.equal(loss, dwant_loss), f"12b buckets K={k}: loss")
        _grads_equal(torch, {n: got[n] for n in dwant if n not in tail},
                     {n: g for n, g in dwant.items() if n not in tail},
                     f"buckets K={k}")
        _grads_equal(torch, {n: got[n] for n in tail},
                     {n: dwant[n].to(cd).float() for n in tail},
                     f"buckets K={k} (tail through {cd})")
        arms[f"DDP buckets K={k}"] = (lambda k=k: bucket_pass(k))
    ov["DDP buckets K=4"] = _trace_overlap(torch, lambda: bucket_pass(4))
    check(ov["DDP buckets K=4"] is not None, "12b buckets: empty trace")
    for path, launches in paths.items():
        for k in TRAIN_KERNELS:
            check(launches[k] > 0, f"12b {path}: {k} never launched")
    med.update(_pass_turns(torch, arms))
    for name in ("prefetch2", "prefetch3"):
        print(f"  [{card}] 12b {name}: gradients bit for bit the "
              f"on-demand path's; gathered layer weights peak "
              f"{out[name]['peak_bytes']} bytes against "
              f"{out[name]['k_layers_bytes']} ({name[-1]} layers of "
              f"{layer_bytes} bytes)")
    print(f"  [{card}] 12b composed (Zero3, 4 buckets of {L // 4} layers): "
          f"loss and gradients bit for bit the on-demand path's, peak "
          f"{out['composed_b4']['peak_bytes']} bytes (one layer)")
    print(f"  [{card}] 12b buckets K=4, K=12 (DDP): block gradients bit for "
          f"bit the plain path's, the tail equal to the plain tail through "
          f"{cd} (JAX's compute-dtype pmean)")
    for name, (share, comm, comp, names) in ov.items():
        print(f"  [{card}] 12b one profiled {name} pass: collectives "
              f"{comm:.4f} ms on side streams, {share:.4f} of it overlapping "
              f"compute kernels ({comp:.3f} ms of kernels on the compute "
              f"stream); side records {names}")
    print(f"  [{card}] 12b forward + backward ms, median of 3 in turns: "
          + ", ".join(f"{a} {m:.3f}" for a, m in med.items()))
    out.update(overlap={k: v[:3] for k, v in ov.items()}, pass_ms=med)
    del ddp, ds, dp
    torch.cuda.empty_cache()
    return paths, out


def hpz_layout(port, card, data=8, n_gran=2):
    """12c: hpZ on gpt2-1.5b at `data` ranks over `n_gran` granules, from
    the shard layout (parallel/zero3.py's flat per-layer shards): the
    per-rank replica bytes and the gather wire a step per rank (received
    bytes; the forward's and the recompute's layer gathers and the
    non-block leaves' one f32 gather), and the part that crosses
    granules."""
    import math as m
    cfg = port.GPT2_PRESETS["gpt2-1.5b"]
    shapes = port.GPT2Model.param_shapes(types.SimpleNamespace(config=cfg))
    L, ici = cfg.n_layer, data // n_gran
    blk_s = sum(-(-m.prod(s[1:]) // data) for n, s in shapes.items()
                if n.startswith("h."))  # one layer's shard, elements
    tail_s = sum(-(-m.prod(s) // data) for n, s in shapes.items()
                 if not n.startswith("h."))
    tail = (data - 1) * tail_s * 4
    tail_x = (data - ici) * tail_s * 4
    plain = 2 * L * (data - 1) * blk_s * 2 + tail
    plain_x = 2 * L * (data - ici) * blk_s * 2 + tail_x
    rebuild = (n_gran - 1) * blk_s * L * 2
    hpz = rebuild + 2 * L * (ici - 1) * n_gran * blk_s * 2 + tail
    hpz_x = rebuild + tail_x
    replica = n_gran * blk_s * L * 2
    print(f"  [{card}] 12c hpZ, gpt2-1.5b at data {data} over {n_gran} "
          f"granules of {ici} (from the layout, not measured): replica "
          f"{replica / 2 ** 30:.3f} GiB a rank (its own bf16 block shards "
          f"{blk_s * L * 2 / 2 ** 30:.3f} GiB); gather wire a step a rank: "
          f"without hpZ {plain / 1e9:.3f} GB ({plain_x / 1e9:.3f} GB across "
          f"granules), with hpZ {hpz / 1e9:.3f} GB ({hpz_x / 1e9:.3f} GB "
          f"across granules: the one rebuild {rebuild / 1e9:.3f} GB + the "
          f"f32 tail)")
    return {"replica_bytes": replica, "wire_plain": plain,
            "wire_plain_cross": plain_x, "wire_hpz": hpz,
            "wire_hpz_cross": hpz_x}

# -- phase 13: the grad-comm codecs -----------------------------------------

CODEC_ENGINES = (("codec_ddp_int8", "DDP", dict(grad_comm="int8")),
                 ("codec_zero2_fp8_b4", "Zero2",
                  dict(grad_comm="fp8", grad_buckets=4)),
                 ("codec_zero3_int8_tail", "Zero3",
                  dict(grad_comm="int8", grad_comm_tail="int8")))
# gpt2-124m's whole gradient (the untied head included), f32 elements
CODEC_ELEMS = 163_109_376


def codec_engines_phase(torch, port, counters, card):
    """13a: each codec knob set through its engine at world 1 — JAX's
    inert warning, the plain lowering, 3 steps bit for bit
    SingleDevice's; the quantizer launched no time."""
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    want_l, want_p, _, _ = _sched_steps(torch, port, "SingleDevice", cfg)
    paths = {}
    for path, name, kw in CODEC_ENGINES:
        for fn in counters.values():
            fn.launches = 0
        losses, params, eng, warns = _sched_steps(torch, port, name, cfg,
                                                  **kw)
        paths[path] = {k: fn.launches for k, fn in counters.items()}
        for k in TRAIN_KERNELS:
            check(paths[path][k] > 0, f"13a {path}: {k} never launched")
        check(paths[path]["quantize_blockwise"] == 0,
              f"13a {path}: the quantizer ran on an inert codec")
        slots = [w for w in warns if "inert on a 1-device data axis" in w]
        check(len(slots) == 1 + (name == "Zero3") and all(
            "grad slot" in w or "gather slot" in w for w in slots),
            f"13a {path}: warnings {warns}")
        check(eng._schedule.lowering == "plain"
              and eng._schedule.residual_len == 0,
              f"13a {path}: lowering {eng._schedule.lowering}")
        check(losses == want_l and all(torch.equal(p, want_p[n])
                                       for n, p in params.items()),
              f"13a {path}: losses {losses} vs {want_l} or params differ")
        print(f"  [{card}] 13a {name}({kw}): "
              f"{'; '.join(w.split(';')[0] for w in slots)}; lowering "
              f"plain; 3 steps bit for bit SingleDevice's: losses {losses}; "
              f"quantize_blockwise.launches 0")
        del eng, params
    torch.cuda.empty_cache()
    return paths


@contextlib.contextmanager
def plain_quantizer(comm, qm):
    """comm's quantizer swapped for the plain version (on the same CUDA
    tensors): the codec's reference arm."""
    real = comm.quantize_blockwise

    def plain(x, mode, block=256, dither=None):
        return qm._quantize_plain(x.reshape(-1), mode, block, dither)

    comm.quantize_blockwise = plain
    try:
        yield
    finally:
        comm.quantize_blockwise = real


def _same_dict(torch, a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def codec_sync_phase(torch, port, qm, counters, card):
    """13b: the codec functions over the one-rank NCCL group on one
    gpt2-124m phase-4 gradient (B=8, T=1024, bf16 compute, f32 masters):
    the int8 sync (dither, error feedback) and the fp8 one bit for bit
    the same calls on the plain quantizer, the residual exactly err -
    dequant, 2 launches of #10 a sync; the hpZ rebuild codec on the
    rank's block shards, 1 launch, equal to the plain version; #10 at
    the codec's shape in turns with its plain version, and one whole
    sync's device and host ms."""
    import torch.distributed as dist
    from tiny_deepspeed_tpu_torch.parallel import comm
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    model = port.GPT2Model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    batch = port.TokenLoader(None, batch=8, seq=1024,
                             vocab_size=cfg.vocab_size, seed=0).next()
    _, grads = loss_and_grads(torch, model, batch)
    total = sum(g.numel() for g in grads.values())
    check(total == CODEC_ELEMS, f"13b: {total} gradient elements")
    e_pad = comm.padded_size(total, 1, 256)
    g = torch.Generator(device="cuda").manual_seed(13)
    residual = torch.randn(e_pad, generator=g, device="cuda") * 1e-4
    group = dist.group.WORLD
    out, paths = {}, {}
    qz = counters["quantize_blockwise"]
    for mode in ("int8", "fp8"):
        key = comm.SyncKey(5, 0) if mode == "int8" else None

        def sync():
            return comm.quantized_grad_sync(grads, residual, group, 1, mode,
                                            key=key)
        for fn in counters.values():
            fn.launches = 0
        red, nres = sync()
        torch.cuda.synchronize()
        paths[f"codec_sync_{mode}"] = {k: fn.launches
                                       for k, fn in counters.items()}
        check(qz.launches == 2, f"13b {mode}: {qz.launches} launches of "
              "#10 in one sync (2 expected)")
        with plain_quantizer(comm, qm):
            pred, pres = sync()
        check(_same_dict(torch, red, pred) and torch.equal(nres, pres),
              f"13b {mode}: the sync differs from the plain quantizer's")
        flat = torch.cat([grads[k].reshape(-1).float()
                          for k in sorted(grads)])
        err = flat + residual
        d = (comm.draw_dither(5, 0, None, "rs", e_pad, "cuda")
             if mode == "int8" else None)
        q, sc = qm.quantize_blockwise(err, mode, 256, d)
        check(torch.equal(nres, err - qm.dequantize_blockwise(q, sc)),
              f"13b {mode}: the residual is not err - dequant(q, s)")
        rerr = max(max_err(red[k], grads[k]) for k in grads)
        out[mode] = {"reduced_max_abs_err_vs_local": rerr,
                     "residual_absmax": float(nres.abs().max())}
        print(f"  [{card}] 13b quantized_grad_sync {mode} over "
              f"{total} elements ({e_pad} padded), error feedback"
              f"{', dither' if key else ''}: reduced gradient and residual "
              f"bit for bit the plain quantizer's; residual = err - "
              f"dequant exactly (|r| max {out[mode]['residual_absmax']:.4g}); "
              f"#10 launches "
              f"{paths[f'codec_sync_{mode}']['quantize_blockwise']}; "
              f"|reduced - local| max "
              f"{rerr:.4g}")
        del red, nres, pred, pres, flat, err, q, sc, d
        torch.cuda.empty_cache()
    rows = {n[2:]: p.detach().to(cfg.compute_dtype).reshape(cfg.n_layer, -1)
            for n, p in model.param_dict().items() if n.startswith("h.")}
    for mode in ("int8", "fp8"):
        for fn in counters.values():
            fn.launches = 0
        rep = comm.hpz_rebuild(rows, mode, group, 1)
        torch.cuda.synchronize()
        paths[f"codec_hpz_{mode}"] = {k: fn.launches
                                      for k, fn in counters.items()}
        check(qz.launches == 1, f"13b hpZ {mode}: {qz.launches} launches")
        with plain_quantizer(comm, qm):
            prep = comm.hpz_rebuild(rows, mode, group, 1)
        check(_same_dict(torch, rep, prep), f"13b hpZ {mode}: the replica "
              "differs from the plain quantizer's")
        rerr = max(max_err(rep[k][:, 0], rows[k]) for k in rows)
        print(f"  [{card}] 13b hpZ rebuild codec {mode} on the rank's "
              f"{sum(r.numel() for r in rows.values())} block elements "
              f"(bf16): replica bit for bit the plain quantizer's; #10 "
              f"launches 1; |replica - shard| max {rerr:.4g}")
        out[f"hpz_{mode}"] = {"replica_max_abs_err": rerr}
        del rep, prep
    del rows, model
    torch.cuda.empty_cache()

    # #10 at the codec's shape: the error-fed flat, block 256, a dither
    n = e_pad
    x = torch.randn(n, generator=g, device="cuda")
    d = torch.rand(n, generator=g, device="cuda") - 0.5
    q, sc = qm.quantize_blockwise(x, "int8", 256, d)
    pq, psc = qm._quantize_plain(x, "int8", 256, d)
    check(torch.equal(q, pq) and torch.equal(sc, psc),
          "13b: #10 at the codec's shape differs from its plain version")
    err = max(max_err(q, pq), max_err(sc, psc))
    del q, sc, pq, psc
    kern = lambda: qm.quantize_blockwise(x, "int8", 256, d)  # noqa: E731
    plain = lambda: qm._quantize_plain(x, "int8", 256, d)  # noqa: E731
    bms, by = bound_ms(n * 9 + 4 * (n // 256), 5 * n, "float32")
    t = sides_in_turns(torch, {"kernel": kern, "plain": plain}, reps=5, n=5)
    res = dict(ms=device_ms(torch, kern, iters=10),
               plain_ms=device_ms(torch, plain, iters=5), library_ms=None,
               call_ms=time_ms(torch, kern, iters=10), bound_ms=bms,
               bound_by=by, max_abs_err=err,
               shape=f"{n // 256}x256 float32 int8 dither (grad codec)",
               turns_ms=t["kernel"][0], turns_spread_ms=list(t["kernel"][1:]),
               plain_turns_ms=t["plain"][0],
               plain_turns_spread_ms=list(t["plain"][1:]))
    del x, d
    torch.cuda.empty_cache()
    # one whole sync: device ms (profiler) and host ms (perf_counter)
    key = comm.SyncKey(5, 0)

    def whole():
        return comm.quantized_grad_sync(grads, residual, group, 1, "int8",
                                        key=key)
    sync_dev = device_ms(torch, whole, iters=3, warmup=1)
    hosts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole()
        torch.cuda.synchronize()
        hosts.append((time.perf_counter() - t0) * 1e3)
    out["sync_int8"] = {"device_ms": sync_dev,
                        "host_ms": statistics.median(hosts),
                        "host_spread_ms": [min(hosts), max(hosts)]}
    print(f"  [{card}] 13b #10 at {res['shape']}: {res['ms']:.5g} ms "
          f"against its {bms:.5g} ms bound ({by}; 9 B an element + 4 B a "
          f"block at 3.35 TB/s), plain {res['plain_ms']:.5g} ms; in turns "
          f"(kernel, plain, plain, kernel) x 5: kernel "
          f"{res['turns_ms']:.5g} [{res['turns_spread_ms'][0]:.5g}, "
          f"{res['turns_spread_ms'][1]:.5g}], plain "
          f"{res['plain_turns_ms']:.5g} [{res['plain_turns_spread_ms'][0]:.5g}"
          f", {res['plain_turns_spread_ms'][1]:.5g}]; one whole int8 sync "
          f"{sync_dev:.5g} device ms, {out['sync_int8']['host_ms']:.5g} host "
          f"ms (median of 5, [{min(hosts):.5g}, {max(hosts):.5g}]; world 1: "
          f"the collectives are copies)")
    del grads, residual
    torch.cuda.empty_cache()
    return paths, res, out


def codec_exec_phase(torch, port, qm, counters, card):
    """13c: the executors at world 1 with an int8 codec, as phase 12b
    builds them: DDP's bucketed release at K=4 with the tail through the
    codec, and Zero3's composed schedule at K=4 with `grad_comm_tail`
    int8 — gradients and the new residual row bit for bit the same pass
    on the plain quantizer, the row JAX's `residual_len` long, #10
    launched 4 x 2 + 2 = 10 times a pass."""
    import torch.distributed as dist
    from tiny_deepspeed_tpu_torch.parallel import comm
    from tiny_deepspeed_tpu_torch.parallel import schedule as S
    from tiny_deepspeed_tpu_torch.parallel.zero3 import LayerGather
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    L, K = cfg.n_layer, 4
    batch = port.TokenLoader(None, batch=8, seq=1024,
                             vocab_size=cfg.vocab_size, seed=0).next()
    codec = S.Codec(mode="int8", group=dist.group.WORLD, n=1, rank=0)
    paths, out = {}, {}
    qz = counters["quantize_blockwise"]

    def run(eng, lowering, tail_codec, drive):
        shapes = eng.model.param_shapes()
        lay = comm.bucket_layout(shapes, L, K, 1, 256)
        eng._schedule = S.Schedule(
            grad=S.GradSlot(buckets=K, mode="int8", tail_mode=tail_codec),
            gather=S.GatherSlot() if eng.stage >= 3 else None,
            lowering=lowering, layout=lay,
            residual_len=lay["residual_len"])
        eng._codec = codec
        eng._tail_codec = codec if tail_codec != "fp32" else None
        residual = eng.zero_residual()
        residual.normal_(0.0, 1e-4)
        for fn in counters.values():
            fn.launches = 0
        loss, grads, new_res = drive(residual)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        with plain_quantizer(comm, qm):
            ploss, pgrads, pres = drive(residual)
        check(torch.equal(loss, ploss) and _same_dict(torch, grads, pgrads)
              and torch.equal(new_res, pres),
              f"13c {lowering}: gradients or residual differ from the plain "
              "quantizer's pass")
        check(new_res.numel() == lay["residual_len"] == K * lay["bucket_pad"]
              + lay["tail_pad"], f"13c {lowering}: residual row "
              f"{new_res.numel()} long")
        check(launches["quantize_blockwise"] == 2 * K + 2,
              f"13c {lowering}: {launches['quantize_blockwise']} launches of "
              f"#10 (10 expected)")
        for k in TRAIN_KERNELS:
            check(launches[k] > 0, f"13c {lowering}: {k} never launched")
        return launches, lay["residual_len"], float(loss)

    ddp = port.DDP(port.build_model(cfg), port.AdamW(lr=1e-5))
    ds = ddp.init(0)
    didx, dtg = (ddp._local(a) for a in batch)
    paths["codec_exec_bucket4"], rl, loss = run(
        ddp, "bucket", "fp32",
        lambda r: ddp._bucketed(ds.params, didx, dtg, None, r, 0))
    out["bucket4"] = {"residual_len": rl, "loss": loss}
    print(f"  [{card}] 13c BucketRelease, DDP, int8 buckets K=4 + the tail: "
          f"gradients and the {rl}-element residual row bit for bit the "
          f"plain quantizer's pass; #10 launches 10")
    del ddp, ds
    torch.cuda.empty_cache()
    z3 = port.Zero3(port.build_model(cfg), port.AdamW(lr=1e-5))
    zs = z3.init(0)
    zidx, ztg = (z3._local(a) for a in batch)
    z3._exec = S.ScanExecutor(z3, "composed", 0, L // K,
                              LayerGather(z3._z3), codec=codec)
    paths["codec_exec_composed4"], rl, loss = run(
        z3, "composed", "int8",
        lambda r: z3._composed(zs.params, zidx, ztg, None, r, 0))
    out["composed4_tail"] = {"residual_len": rl, "loss": loss}
    print(f"  [{card}] 13c ScanExecutor composed, Zero3, int8 buckets K=4 + "
          f"grad_comm_tail int8: gradients and the {rl}-element residual "
          f"row bit for bit the plain quantizer's pass; #10 launches 10")
    del z3, zs
    torch.cuda.empty_cache()
    return paths, out


# -- phase 14: Ulysses and rank-invariant dropout ----------------------------

FA2_KERNELS = ("fa2_flash_attention_fwd", "fa2_flash_attention_dq",
               "fa2_flash_attention_dkv")
FA2_PLAIN = ("_fa2_fwd_plain", "_fa2_dq_plain", "_fa2_dkv_plain")
# (model, q heads, K/V heads) of 14a / 14b, at B=8 T=1024 Dh=64 bf16
ULY_SHAPES = (("gpt2-124m", 12, 12), ("llama-160m", 12, 4))
ULY_B, ULY_T, ULY_D = 8, 1024, 64
# 14c's engines at world 1 (Ulysses inert without a seq split)
ULY_ENGINES = (("uly_drop_ddp", "DDP"), ("uly_drop_zero2", "Zero2"),
               ("uly_drop_zero3", "Zero3"))
DROP_SHAPE = (8, 1024, 768)  # phase 4's residual, (B, T, C)


def dropout_launches_per_step(cfg):
    """The dropout kernel's launches in one training step: the embedding's
    and each layer's two sites in the forward, the same in the backward
    (DropoutFn's gradient is the kernel on dy), and, under remat, each
    layer's site 0 again in the recompute — site 1's output feeds only
    the residual add, whose backward keeps nothing, so the checkpoint's
    early stop never redraws it."""
    n_l = cfg.n_layer
    fwd = 1 + 2 * n_l
    remat = n_l if cfg.remat and cfg.remat_policy != "all" else 0
    return 2 * fwd + remat


def _uly_inputs(torch, hq, kvh, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(ULY_B, h, ULY_T, ULY_D, generator=g,
                        device="cuda").bfloat16() for h in (hq, kvh, kvh)]


def _whole_attention(torch, q, k, v):
    """The whole-sequence FA2 kernels on one thread: o and the gradients
    of sum(o^2) (do = 2o, exact in bf16)."""
    from tiny_deepspeed_tpu_torch.ops.attention import flash_attention
    args = [z.detach().requires_grad_() for z in (q, k, v)]
    o = flash_attention(*args)
    return (o.detach(), *torch.autograd.grad(o, args, o.detach() * 2))


class _CountingComm:
    """An all-to-all communicator that adds the bytes of what it is given
    (this rank's share of each all-to-all) to `moved`."""

    def __init__(self, comm, moved):
        self.comm, self.moved = comm, moved
        self.rank, self.size = comm.rank, comm.size

    def all_to_all(self, x):
        self.moved.append(x.numel() * x.element_size())
        return self.comm.all_to_all(x)


def ulysses_lockstep_phase(torch, fa, counters, card):
    """14a: `ulysses_fwd` / `ulysses_bwd` over n lockstep threads on the
    card (n = 2, 4), the local attention the FA2 kernels #4-#6 on whole
    sequences, at gpt2-124m's and llama-160m's attention shapes (the
    latter grouped: K/V cross the all-to-alls at kv_heads), forward and
    backward of sum(o^2): o, dq, dk, dv within 2e-2 x max|ref| of the
    whole-sequence kernels on one thread; #4, #5, #6 launched exactly n
    times each a call, no other kernel, no plain version; each
    all-to-all's bytes against the expanded route's."""
    from tiny_deepspeed_tpu_torch.ops.attention import flash_attention
    from tiny_deepspeed_tpu_torch.parallel import ulysses as U
    res, paths = {}, {}
    for model, hq, kvh in ULY_SHAPES:
        q, k, v = _uly_inputs(torch, hq, kvh, seed=hq + kvh)
        ref = _whole_attention(torch, q, k, v)
        torch.cuda.synchronize()
        for n in (2, 4):
            tl, moved = ULY_T // n, []

            def rank(r, comm, tl=tl, n=n):
                args = [z[:, :, r * tl:(r + 1) * tl].contiguous()
                        for z in (q, k, v)]
                c = _CountingComm(comm, moved) if r == 0 else comm
                o, saved = U.ulysses_fwd(*args, c, flash_attention)
                return (o, *U.ulysses_bwd(saved, o * 2, c))

            calls = []
            for fn in counters.values():
                fn.launches = 0
            with counted_plain_fa2(fa, calls):
                t0 = time.perf_counter()
                out = U.run_lockstep(n, rank)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            want = {kn: n for kn in FA2_KERNELS}
            check({kn: launches[kn] for kn in want} == want and not any(
                c for kn, c in launches.items() if kn not in want),
                f"14a {model} n={n}: launches {launches}, want {want}")
            check(not calls, f"14a {model} n={n}: plain versions ran {calls}")
            got = [torch.cat([o[i] for o in out], dim=2) for i in range(4)]
            errs = {nm: _rel_err(a, b) for nm, a, b in
                    zip(("o", "dq", "dk", "dv"), got, ref)}
            check(all(rel <= 2e-2 for _, rel in errs.values()),
                  f"14a {model} n={n}: against the whole-sequence kernels "
                  f"{errs}")
            # q, k, v to heads, o home; do to heads, dq, dk, dv home: the
            # expanded route moves each at q's heads
            expanded = len(moved) * moved[0]
            res[model, n] = dict(errs=errs, bytes=moved, wall_ms=wall * 1e3,
                                 bytes_expanded=expanded)
            paths[f"ulysses{n}_{model}"] = launches
            print(f"  [{card}] 14a {model} (B={ULY_B} Hq={hq} KVH={kvh} "
                  f"T={ULY_T} Dh={ULY_D} bf16) over {n} lockstep threads: "
                  + ", ".join(f"{nm} max_abs_err={e:.3g} ({rel:.3g} of "
                              f"max|ref|)" for nm, (e, rel) in errs.items())
                  + f" (tol 2e-2); #4/#5/#6 launches {n} each; rank 0's "
                  f"all-to-all bytes {moved} = {sum(moved)} a call "
                  f"(expanded K/V: {expanded}); forward+backward wall "
                  f"{wall * 1e3:.2f} ms (threads in lockstep, not a "
                  f"multi-card time)")
    return res, paths


@contextlib.contextmanager
def counted_plain_fa2(fa, calls):
    """The FA2 plain versions wrapped to count their calls into `calls`."""
    changes = []
    for attr in FA2_PLAIN:
        fn = getattr(fa, attr)

        def wrapped(*a, _fn=fn, _name=attr, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        changes.append((fa, attr, wrapped))
    with swapped(*changes):
        yield


def ulysses_group_phase(torch, card):
    """14b: `ulysses_attention` (its autograd Functions) over the real
    one-rank NCCL group's `GroupAllToAll`, at 14a's shapes: o, dq, dk, dv
    bit for bit the direct kernel call."""
    import torch.distributed as dist
    from tiny_deepspeed_tpu_torch.ops.attention import flash_attention
    from tiny_deepspeed_tpu_torch.parallel import mesh
    from tiny_deepspeed_tpu_torch.parallel import ulysses as U
    comm = mesh.GroupAllToAll(dist.group.WORLD)
    for model, hq, kvh in ULY_SHAPES:
        q, k, v = _uly_inputs(torch, hq, kvh, seed=hq + kvh + 1)
        ref = _whole_attention(torch, q, k, v)
        args = [z.detach().requires_grad_() for z in (q, k, v)]
        o = U.ulysses_attention(*args, comm, flash_attention)
        got = (o.detach(), *torch.autograd.grad(o, args, o.detach() * 2))
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(got, ref)]
        check(all(same), f"14b {model}: not bit for bit the kernel call "
              f"(o, dq, dk, dv equal: {same})")
        print(f"  [{card}] 14b {model}: ulysses_attention over the one-rank "
              f"NCCL group = the direct FA2 call bit for bit (o, dq, dk, "
              f"dv)")


def ulysses_engines_phase(torch, port, counters, card):
    """14c: DDP, Zero2 and Zero3 at world 1 with seq_impl="ulysses" and
    dropout 0.1 on gpt2-124m (phase 4's config), 3 steps each: losses and
    params bit for bit SingleDevice's with dropout 0.1, the dropout
    kernel's launches exactly `dropout_launches_per_step` a step."""
    cfg = dataclasses.replace(port.GPT2_PRESETS["gpt2-124m"], dropout=0.1)
    per = dropout_launches_per_step(cfg)
    for fn in counters.values():
        fn.launches = 0
    want_l, want_p, _, _ = _sched_steps(torch, port, "SingleDevice", cfg)
    single = {k: fn.launches for k, fn in counters.items()}
    check(single["dropout"] == 3 * per,
          f"14c SingleDevice: dropout launches {single['dropout']}, want "
          f"3 x {per}")
    paths = {"uly_drop_single": single}
    for path, name in ULY_ENGINES:
        for fn in counters.values():
            fn.launches = 0
        losses, params, eng, _ = _sched_steps(torch, port, name, cfg,
                                              seq_impl="ulysses")
        launches = {k: fn.launches for k, fn in counters.items()}
        paths[path] = launches
        check(eng.pctx.seq_impl == "ulysses", f"14c {name}: seq_impl")
        check(launches["dropout"] == 3 * per,
              f"14c {name}: dropout launches {launches['dropout']}, want "
              f"3 x {per}")
        for kn in TRAIN_KERNELS:
            check(launches[kn] > 0, f"14c {name}: {kn} never launched")
        check(not any(launches[kn] for kn in CHUNK_KERNELS),
              f"14c {name}: a ring chunk kernel ran")
        check(losses == want_l and all(torch.equal(p, want_p[nm])
                                       for nm, p in params.items()),
              f"14c {name}: losses {losses} vs {want_l} or params differ")
        print(f"  [{card}] 14c {eng.describe()} seq_impl=ulysses, dropout "
              f"0.1: 3 steps bit for bit SingleDevice's (losses {losses}); "
              f"dropout launches {launches['dropout']} = 3 x {per} "
              f"(1 + 2L forward, L recompute, 1 + 2L backward)")
        del eng, params
    torch.cuda.empty_cache()
    return paths


def parent_dropout(torch, x, key, keep):
    """The parent's dropout: a mask from a generator seeded with the key
    (`torch.rand < keep` over the rank's own shape), then where."""
    g = torch.Generator(device=x.device).manual_seed(key)
    mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def dropout_phase(torch, F, D, card):
    """14d: the dropout kernel at phase 4's residual shape (8 x 1024 x
    768), bf16 and f32: bit for bit its plain version, forward and
    through DropoutFn's backward; the whole mask's output equal, bit for
    bit, to the same tensor dropped as 4 row blocks and as 2 token blocks
    at their offsets; timed (device ms, plain, F.dropout — not the same
    bits, so time only) and in turns against the parent's rand + where
    and F.dropout, host ms a call, its bound in bytes."""
    from tiny_deepspeed_tpu_torch import rng as prng
    key, rate = prng.fold_in(prng.fold_in(0, 0xD0), 14), 0.1
    keep = 1.0 - rate
    b, t, c = DROP_SHAPE
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(14)
        x = torch.randn(DROP_SHAPE, generator=g, device="cuda").to(dtype)
        dname = str(dtype)[6:]
        before = D.dropout.launches
        y = D._dropout_triton(x, key, keep, None)
        torch.cuda.synchronize()
        check(D.dropout.launches == before + 1, f"14d {dname}: not one launch")
        check(torch.equal(y, D._dropout_plain(x, key, keep, None)),
              f"14d {dname}: the kernel is not bit for bit its plain version")
        kept = float((y != 0).float().mean())
        check(abs(kept - keep) < 1e-3, f"14d {dname}: kept share {kept}")
        blocks = [((2 * i, 0, 0), x[2 * i:2 * i + 2]) for i in range(4)]
        tokens = [((0, 512 * j, 0), x[:, 512 * j:512 * (j + 1)])
                  for j in range(2)]
        for (off, xb) in blocks + tokens:
            yb = D._dropout_triton(xb.contiguous(), key, keep,
                                   (DROP_SHAPE, off))
            sl = tuple(slice(o, o + n) for o, n in zip(off, xb.shape))
            check(torch.equal(yb, y[sl]),
                  f"14d {dname}: the block at {off} is not the whole "
                  "mask's block")
        xr = x.detach().requires_grad_()
        dy = torch.randn(DROP_SHAPE, generator=g, device="cuda").to(dtype)
        before = D.dropout.launches
        yr = D.dropout(xr, key, rate)
        (dx,) = torch.autograd.grad(yr, xr, dy)
        torch.cuda.synchronize()
        check(D.dropout.launches == before + 2 and torch.equal(yr, y)
              and torch.equal(dx, D._dropout_plain(dy, key, keep, None)),
              f"14d {dname}: DropoutFn's forward / backward")

        def kernel():
            return D._dropout_triton(x, key, keep, None)

        def plain():
            return D._dropout_plain(x, key, keep, None)

        def par():
            return parent_dropout(torch, x, key, keep)

        def lib():
            return F.dropout(x, rate, training=True)

        # x read once, y written once; a compare and a divide an element
        bms, by = bound_ms(2 * x.numel() * x.element_size(), 0, "float32")
        r = dict(ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
                 library_ms=device_ms(torch, lib),
                 call_ms=time_ms(torch, kernel),
                 **three_sides(torch, kernel, par, lib), bound_ms=bms,
                 bound_by=by, max_abs_err=0.0,
                 shape=f"{b}x{t}x{c} {dname}")
        res[dname] = r
        print(f"  [{card}] 14d dropout {b}x{t}x{c} {dname}: bit for bit the "
              f"plain version (forward and DropoutFn's backward); whole = "
              f"4 row blocks = 2 token blocks bit for bit; kept "
              f"{kept:.5f}; "
              + " ".join(f"{k}={r[k]:.5g}" for k in
                         ("ms", "plain_ms", "library_ms", "call_ms",
                          "bound_ms"))
              + f" (bound by {by}); " + sides_text(r))
    return res


# -- phase 15: telemetry and optimizer-state offload -----------------------

OFFLOAD_ARMS = (("offload_off", {}),
                ("offload_w1", dict(offload_opt_state=True,
                                    offload_prefetch=1)),
                ("offload_w2", dict(offload_opt_state=True,
                                    offload_prefetch=2)))
# the W=2 arm's engine steps at these windows in turns after its arm:
# the window counts leaves, and in GPT-2's leaf order a bias sits
# between two large matrices, so only W >= 3 lets one's inbound copy
# run under the other's outbound one
OFFLOAD_TURNS = (1, 2, 4, 4, 2, 1)
TELEM_ARMS = ("telem_off", "telem_on", "telem_layers")


def _count(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _merge_spans(spans):
    """(start, end) spans merged into a sorted list of disjoint ones."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _shared_us(xs, ys):
    """The time two lists of merged spans cover together."""
    i = j = 0
    both = 0.0
    while i < len(xs) and j < len(ys):
        both += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return both


def copy_overlap(torch, prof):
    """From a profiled pass's device records (their start and end, us):
    the time the HtoD copies cover, the DtoH copies, both directions at
    once, and each direction under a kernel, in ms.  None when the pass
    holds no copy of one direction."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = {"htod": [], "dtoh": [], "kernel": []}
    for e in prof.events():
        if getattr(e, "device_type", None) != cuda:
            continue
        if e.name.startswith("Memcpy HtoD"):
            k = "htod"
        elif e.name.startswith("Memcpy DtoH"):
            k = "dtoh"
        elif e.name.startswith(("Memcpy", "Memset")):
            continue
        else:
            k = "kernel"
        spans[k].append((e.time_range.start, e.time_range.end))
    if not spans["htod"] or not spans["dtoh"]:
        return None
    m = {k: _merge_spans(v) for k, v in spans.items()}
    return {"htod_cover_ms": sum(b - a for a, b in m["htod"]) / 1e3,
            "dtoh_cover_ms": sum(b - a for a, b in m["dtoh"]) / 1e3,
            "both_ms": _shared_us(m["htod"], m["dtoh"]) / 1e3,
            "htod_under_kernels_ms": _shared_us(m["htod"],
                                                m["kernel"]) / 1e3,
            "dtoh_under_kernels_ms": _shared_us(m["dtoh"],
                                                m["kernel"]) / 1e3}


def copy_directions(torch, nbytes=1 << 30, reps=3):
    """Pinned host <-> device copies of `nbytes`: HtoD alone, DtoH alone
    and both at once on two streams, in turns, CUDA events, median of
    `reps` each: whether the card and its host move both directions at
    once.  Returns {mode: ms} and {mode: GB/s of the bytes moved}."""
    n = nbytes // 4
    h_in = torch.ones(n, dtype=torch.float32, pin_memory=True)
    h_out = torch.empty(n, dtype=torch.float32, pin_memory=True)
    d_in = torch.empty(n, dtype=torch.float32, device="cuda")
    d_out = torch.ones(n, dtype=torch.float32, device="cuda")
    up, down = torch.cuda.Stream(), torch.cuda.Stream()

    def run(ups, downs):
        cur = torch.cuda.current_stream()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(cur)
        up.wait_stream(cur)
        down.wait_stream(cur)
        if ups:
            with torch.cuda.stream(up):
                d_in.copy_(h_in, non_blocking=True)
        if downs:
            with torch.cuda.stream(down):
                h_out.copy_(d_out, non_blocking=True)
        cur.wait_stream(up)
        cur.wait_stream(down)
        b.record(cur)
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    modes = {"htod": (1, 0), "dtoh": (0, 1), "both": (1, 1)}
    times = {m: [] for m in modes}
    run(1, 1)
    for _ in range(reps):
        for m, (u, d) in modes.items():
            times[m].append(run(u, d))
    check(bool((d_in == 1).all()) and bool((h_out == 1).all()),
          "15a: the copy probe moved other bytes")
    ms = {m: statistics.median(t) for m, t in times.items()}
    rate = {m: nbytes * (2 if m == "both" else 1) / (ms[m] * 1e6)
            for m in modes}
    return ms, rate


def _offload_arm(torch, port, counters, card, cfg, batches, path, kw,
                 ref, turns=()):
    """One arm of 15a, its engine and state local to this call (so the
    next arm's resting and peak bytes are its own): 3 steps, counts
    zeroed just before and read just after, the resting and peak bytes,
    the params and moments against `ref` (the off arm's, on the host;
    None for the off arm itself), one profiled step, and how long its
    copies ran in each direction, both at once and under kernels
    (`copy_overlap`).  With `turns` (windows) one more step at each, in
    that order, on this engine: the windows in turns on one state; then
    one profiled step at the widest of them.
    Returns (launches, its numbers, its losses / params / moments on the
    host when `ref` is None)."""
    torch.cuda.empty_cache()
    eng = port.Zero3(port.build_model(cfg),
                     port.AdamW(lr=1e-5, weight_decay=0.1, fused=True), **kw)
    state = eng.init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for batch in batches[:3]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = eng.step(state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = _count(counters)
    torch.cuda.synchronize()
    resting = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(state.params)
    got = launches["adamw_update_fused"]
    check(got == 3 * n_leaves, f"15a {path}: #13 launched {got} times, "
          f"want 3 x {n_leaves} leaves")
    for k in TRAIN_KERNELS:
        check(launches[k] > 0, f"15a {path}: {k} never launched")
    check(all(math.isfinite(x) for x in losses), f"15a {path}: {losses}")
    slots = state.opt_state["state"]
    if kw:
        check(all(t.device.type == "cpu" and t.is_pinned()
                  for s in slots.values() for t in s.values()),
              f"15a {path}: a moment does not rest in pinned memory")
        check(eng.describe().endswith("opt state offloaded=pinned_host)"),
              f"15a {path}: {eng.describe()}")
    params = {n: p.detach().cpu() for n, p in state.params.items()}
    moments = {n: {k: t.cpu() for k, t in s.items()}
               for n, s in slots.items()}
    if ref is not None:
        same = (losses == ref[0]
                and all(torch.equal(t, ref[1][n]) for n, t in params.items())
                and all(torch.equal(t, ref[2][n][k])
                        for n, s in moments.items() for k, t in s.items()))
        check(same, f"15a {path}: losses {losses} vs {ref[0]}, or the "
              "params / moments differ from the off arm")
    prof = profiled(torch, lambda: float(eng.step(state, batches[3])[1]))
    check(prof is not None, f"15a {path}: the profiler recorded no device "
          "time")
    per, busy, _ = kernel_shares(
        torch, prof, {"htod": "Memcpy HtoD", "dtoh": "Memcpy DtoH",
                      "adamw_update_fused": PATTERNS["adamw_update_fused"]})
    r = {"step_ms": [t * 1e3 for t in times],
         "step_ms_median": statistics.median(times) * 1e3,
         "resting_gib": resting / 2 ** 30, "peak_gib": peak / 2 ** 30,
         "htod_ms": per.get("htod", 0.0) / 1e3,
         "dtoh_ms": per.get("dtoh", 0.0) / 1e3,
         "adamw_ms": per.get("adamw_update_fused", 0.0) / 1e3,
         "busy_ms": busy / 1e3, "losses": losses,
         "overlap": copy_overlap(torch, prof) if kw else None}
    if kw:
        check(r["overlap"] is not None,
              f"15a {path}: no copy of one direction in the profiled step")
    by_w = {}
    for i, w in enumerate(turns):
        eng._offload.window = w
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(eng.step(state, batches[i % len(batches)])[1])
        by_w.setdefault(w, []).append((time.perf_counter() - t0) * 1e3)
    if turns:
        r["turns_ms"] = {f"W={w}": t for w, t in by_w.items()}
        eng._offload.window = max(turns)
        wide = profiled(torch, lambda: float(eng.step(state, batches[0])[1]))
        check(wide is not None, f"15a {path}: the profiler recorded no "
              "device time at the widest window")
        r["overlap_widest"] = copy_overlap(torch, wide)
        eng._offload.window = kw["offload_prefetch"]
    print(f"  [{card}] 15a {eng.describe()}: losses {losses}; step ms "
          f"{[round(x, 3) for x in r['step_ms']]} (median "
          f"{r['step_ms_median']:.3f}); resting device "
          f"{r['resting_gib']:.3f} GiB after a step, peak "
          f"{r['peak_gib']:.3f} GiB; one profiled step: Memcpy HtoD "
          f"{r['htod_ms']:.3f} ms, DtoH {r['dtoh_ms']:.3f} ms, #13 "
          f"{r['adamw_ms']:.3f} ms, busy {r['busy_ms']:.3f} ms; #13 "
          f"launches {got} = 3 x {n_leaves} leaves")
    if r["overlap"] is not None:
        print(f"  [{card}] 15a {path} copies in the profiled step (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["overlap"].items()))
    if turns:
        print(f"  [{card}] 15a windows in turns {list(turns)} on one "
              f"state, step ms: " + "; ".join(
                  f"{k} {[round(x, 3) for x in v]} (median "
                  f"{statistics.median(v):.3f})"
                  for k, v in r["turns_ms"].items())
              + f"; copies at W={max(turns)} in one profiled step (ms): "
              + ", ".join(f"{k} {v:.3f}"
                          for k, v in r["overlap_widest"].items()))
    return launches, r, ((losses, params, moments) if ref is None else None)


def offload_phase(torch, port, counters, card, b):
    """15a: Zero3 at world 1 on gpt2-1.5b, B=`b` (8d's) T=1024,
    AdamW(lr=1e-5, wd=0.1, fused=True), offload off / W=1 / W=2 in turn
    from seed 0, 3 steps each on the same batches, then one profiled
    step (`_offload_arm`); the W=2 arm's engine then steps at W=1, 2
    and 4 in turns, and `copy_directions` times 1 GiB copies each way
    alone and both at once."""
    cfg = port.GPT2_PRESETS["gpt2-1.5b"]
    loader = port.TokenLoader(None, batch=b, seq=1024,
                              vocab_size=cfg.vocab_size, seed=0)
    batches = [loader.next() for _ in range(4)]
    paths, res, ref = {}, {}, None
    for path, kw in OFFLOAD_ARMS:
        paths[path], res[path], off = _offload_arm(
            torch, port, counters, card, cfg, batches, path, kw, ref,
            turns=OFFLOAD_TURNS if path == "offload_w2" else ())
        ref = ref or off
    del ref
    off = res["offload_off"]
    for path in ("offload_w1", "offload_w2"):
        check(res[path]["resting_gib"] < off["resting_gib"],
              f"15a {path}: resting device memory did not fall")
    print(f"  [{card}] 15a W=1 and W=2 bit for bit the off arm; resting "
          f"device GiB off / W=1 / W=2: " + " / ".join(
              f"{res[p]['resting_gib']:.3f}" for p, _ in OFFLOAD_ARMS)
          + "; peak GiB " + " / ".join(
              f"{res[p]['peak_gib']:.3f}" for p, _ in OFFLOAD_ARMS)
          + "; step ms " + " / ".join(
              f"{res[p]['step_ms_median']:.3f}" for p, _ in OFFLOAD_ARMS))
    torch.cuda.empty_cache()
    ms, rate = copy_directions(torch)
    res["copy_directions"] = {"ms": ms, "gb_per_s": rate}
    print(f"  [{card}] 15a 1 GiB pinned copies, median of 3 in turns: "
          + "; ".join(f"{m} {ms[m]:.3f} ms ({rate[m]:.2f} GB/s)"
                      for m in ms))
    torch.cuda.empty_cache()
    return paths, res


def _f64_norm(tensors):
    return math.sqrt(sum(float(t.double().square().sum()) for t in tensors))


def telemetry_phase(torch, port, counters, card):
    """15b: phase 4's configuration (gpt2-124m, SingleDevice,
    AdamW(lr=1e-5, wd=0.1), B=8 T=1024, seed 0) with telemetry off, on
    and layers, 10 steps each in turns over the same batches."""
    from tiny_deepspeed_tpu_torch.telemetry import Telemetry
    from tiny_deepspeed_tpu_torch.telemetry import health as H
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    loader = port.TokenLoader(None, batch=8, seq=1024,
                              vocab_size=cfg.vocab_size, seed=0)
    batches = [loader.next() for _ in range(10)]
    arms = {}
    for path in TELEM_ARMS:
        telem = (None if path == "telem_off" else Telemetry(
            layers=path == "telem_layers", tracer=(lambda p: None,
                                                   lambda: None)))
        eng = port.SingleDevice(port.GPT2Model(cfg),
                                port.AdamW(lr=1e-5, weight_decay=0.1),
                                telemetry=telem)
        arms[path] = {"eng": eng, "state": eng.init(0), "telem": telem,
                      "losses": [], "step": [], "host": [],
                      "launches": {k: 0 for k in counters}}
    f64 = None
    for i, batch in enumerate(batches):
        for path, a in arms.items():
            eng, telem = a["eng"], a["telem"]
            check_now = path == "telem_on" and i == len(batches) - 1
            if check_now:  # the same tensors, recomputed in f64
                old = {n: p.detach().clone()
                       for n, p in a["state"].params.items()}
                _, grads = loss_and_grads(torch, eng.model, batch)
            before = _count(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a["state"], loss = eng.step(a["state"], batch)
            t1 = time.perf_counter()
            loss = float(loss)
            t2 = time.perf_counter()
            after = _count(counters)
            for k in counters:
                a["launches"][k] += after[k] - before[k]
            a["losses"].append(loss)
            a["host"].append((t1 - t0) * 1e3)
            a["step"].append((t2 - t0) * 1e3)
            if telem is not None:
                h = telem.poll()
                check(h["loss"] == loss, f"15b {path} step {i}: health loss "
                      f"{h['loss']} vs the step's {loss}")
                check(h["nonfinite_grads"] == 0,
                      f"15b {path}: non-finite gradients {h}")
            if path == "telem_layers":
                mat = telem.layer_health()
                check(mat.shape == (cfg.n_layer, 6)
                      and bool((mat == mat).all()),
                      f"15b layers: matrix {mat.shape}")
            if check_now:
                new = a["state"].params
                want = {"grad_norm": _f64_norm(grads.values()),
                        "update_norm": _f64_norm(
                            new[n].detach() - old[n] for n in new),
                        "param_norm": _f64_norm(
                            p.detach() for p in new.values())}
                f64 = {k: (telem.poll()[k], w) for k, w in want.items()}
                for k, (got, w) in f64.items():
                    check(abs(got - w) <= 1e-4 * abs(w),
                          f"15b {k}: {got} vs the f64 recomputation {w}")
                del old, grads
    want = arms["telem_off"]
    for path, a in arms.items():
        check(a["losses"] == want["losses"],
              f"15b {path}: losses {a['losses']} vs {want['losses']}")
        check(a["launches"] == want["launches"],
              f"15b {path}: launches {a['launches']} vs telemetry off's")
    for k in TRAIN_KERNELS:
        check(want["launches"][k] > 0, f"15b: {k} never launched")
    out = {}
    for path, a in arms.items():
        eng, state = a["eng"], a["state"]

        def one_step():
            float(eng.step(state, batches[0])[1])

        prof = profiled(torch, one_step)
        check(prof is not None, f"15b {path}: no device record")
        recs = sum(e.count for e in _device_records(torch, prof))
        out[path] = {"step_ms": statistics.median(a["step"][1:]),
                     "host_ms": statistics.median(a["host"][1:]),
                     "device_records": recs}
    lay = arms["telem_layers"]
    with torch.no_grad():
        lay["state"].params["h.mlp.fc.w"][5, 0, 0] = float("inf")
    lay["eng"].step(lay["state"], batches[1])
    src = H.first_nonfinite_layer(lay["telem"].layer_health())
    check(src == (5, "act_nonfinite"),
          f"15b: an inf in layer 5's weight localized as {src}")
    print(f"  [{card}] 15b telemetry off / on / layers, 10 steps each in "
          f"turns: losses bit for bit ({want['losses'][-1]!r} last); the "
          f"health's loss the step's; launches unchanged; the inf in layer "
          f"5 localized {src}; f64 recomputation (got, want): {f64}")
    for path, r in out.items():
        print(f"  [{card}] 15b {path}: step {r['step_ms']:.3f} ms, host "
              f"{r['host_ms']:.3f} ms (median of 9), {r['device_records']} "
              f"device records a step")
    paths = {p: a["launches"] for p, a in arms.items()}
    del arms
    torch.cuda.empty_cache()
    return paths, dict(out, f64=f64, first_nonfinite=src)


def drop_exec_phase(torch, port, counters, card):
    """15c: dropout 0.1 through 13c's directly built executors at world
    1 — DDP's bucketed release (K=4) and Zero3's composed schedule (K=4),
    fp32 — one forward and backward of phase 4's batch with the rank-0
    folded key `fold_in(fold_in(fold_in(0, 0xD0), 0), 0)`: loss and
    gradients bit for bit the plain path's under that key (the DDP
    tail equal to the plain tail through the compute dtype, as 12b)."""
    from tiny_deepspeed_tpu_torch import rng as prng
    from tiny_deepspeed_tpu_torch.parallel import comm
    from tiny_deepspeed_tpu_torch.parallel import schedule as S
    from tiny_deepspeed_tpu_torch.parallel.zero3 import LayerGather
    cfg = dataclasses.replace(port.GPT2_PRESETS["gpt2-124m"], dropout=0.1)
    L, K = cfg.n_layer, 4
    key = prng.fold_in(prng.fold_in(prng.fold_in(0, 0xD0), 0), 0)
    batch = port.TokenLoader(None, batch=8, seq=1024,
                             vocab_size=cfg.vocab_size, seed=0).next()
    paths = {}
    ddp = port.DDP(port.build_model(cfg), port.AdamW(lr=1e-5))
    ds = ddp.init(0)
    idx, tg = (ddp._local(a) for a in batch)
    tail = [n for n in ds.params if not n.startswith("h.")]
    lay = comm.bucket_layout(ddp.model.param_shapes(), L, K, 1, 256)
    ddp._schedule = S.Schedule(grad=S.GradSlot(buckets=K),
                               lowering="bucket", layout=lay)
    wl, wg = ddp._loss_and_grads(ds.params, idx, tg, None, key)[:2]
    for fn in counters.values():
        fn.launches = 0
    loss, grads, _ = ddp._bucketed(ds.params, idx, tg, None, rng=key)
    paths["drop_exec_bucket4"] = _count(counters)
    cd = cfg.compute_dtype
    check(torch.equal(loss, wl)
          and all(torch.equal(grads[n], g) for n, g in wg.items()
                  if n not in tail)
          and all(torch.equal(grads[n], wg[n].to(cd).float()) for n in tail),
          "15c bucket: loss or gradients differ from the plain path's")
    del ddp, ds, wg, grads
    torch.cuda.empty_cache()
    z3 = port.Zero3(port.build_model(cfg), port.AdamW(lr=1e-5))
    zs = z3.init(0)
    zp = zs.params
    loss = z3.model.apply(idx, tg, pctx=z3.pctx, params=zp, rng=key)
    wg = dict(zip(zp, torch.autograd.grad(loss, list(zp.values()))))
    wl = loss.detach()
    z3._exec = S.ScanExecutor(z3, "composed", 0, L // K, LayerGather(z3._z3))
    for fn in counters.values():
        fn.launches = 0
    zl, zg, _ = z3._composed(zp, idx, tg, None, rng=key)
    paths["drop_exec_composed4"] = _count(counters)
    check(torch.equal(zl, wl)
          and all(torch.equal(zg[n], g) for n, g in wg.items()),
          "15c composed: loss or gradients differ from the plain path's")
    for path, launches in paths.items():
        check(launches["dropout"] > 0, f"15c {path}: dropout never launched")
        for k in TRAIN_KERNELS:
            check(launches[k] > 0, f"15c {path}: {k} never launched")
    print(f"  [{card}] 15c dropout 0.1 at world 1 under the rank-0 folded "
          f"key {key}: DDP's bucketed release (K={K}) and Zero3's composed "
          f"schedule (K={K}) bit for bit the plain path (the DDP tail "
          f"through {cd}); dropout launches "
          + ", ".join(f"{p} {v['dropout']}" for p, v in paths.items()))
    del z3, zs, zp, wg, zg
    torch.cuda.empty_cache()
    return paths


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; the port's kernels "
              "run on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    import tiny_deepspeed_tpu_torch as port
    from tiny_deepspeed_tpu_torch.ops import _build
    from tiny_deepspeed_tpu_torch.ops import flash_fa2 as fa
    from tiny_deepspeed_tpu_torch.ops import fused_xent as fx
    from tiny_deepspeed_tpu_torch.ops import dropout as dr
    from tiny_deepspeed_tpu_torch.ops import layernorm as ln
    from tiny_deepspeed_tpu_torch.ops import paged_attn as pa
    from tiny_deepspeed_tpu_torch.ops import quant as qm
    from tiny_deepspeed_tpu_torch.ops import rmsnorm as rn
    from tiny_deepspeed_tpu_torch.optim import adamw_fused as af
    from tiny_deepspeed_tpu_torch.serving import pool as pool_mod

    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    print(card)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    os.makedirs(OUT_DIR, exist_ok=True)
    _build.build_all()
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as f:
        for name, log in _build.build_logs.items():
            f.write(f"== {name}\n{log}\n")
    build_report(_build)
    t = time.perf_counter()
    x = torch.randn(4, 768, device="cuda", dtype=torch.bfloat16)
    w, b = (torch.ones(768, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    ln._ln_fwd_triton(x, w, b, 1e-5)
    ln._add_ln_fwd_triton(x, x, w, b, 1e-5)
    torch.cuda.synchronize()
    print(f"phase 1: nvcc build {_build.last_build_s:.2f}s (csrc/*.cu, in "
          f"parallel); the Triton forward pair's first compile (the "
          f"parent's arm) {time.perf_counter() - t:.2f}s")

    print("phase 2: kernel parity on the card (bf16)")
    lap("phase 1")
    ln_res, ln_tri, ln_err, ln_tri_err = layernorm_phase(torch, F, ln)
    fa_res, fa_err = flash_phase(torch, F, fa)
    lap("rows 1, 4")
    pa_res, pa_err = paged_phase(torch, F, pa, pool_mod)
    pq_res, pq_err = paged_quant_phase(torch, F, pa, pool_mod)
    ps_res, ps_err = paged_span_phase(torch, F, pa, pool_mod)
    lap("rows 9a-9c")
    app_res, app_err = append_phase(torch, pa, pool_mod)
    lap("9a/9b with the append")
    qz_res = quantize_phase(torch, qm)
    kv_res, kv_v1_res, kv_err = kv_write_phase(torch, pool_mod, qm)
    aln_res, aln_tri, aln_err, aln_tri_err = add_ln_phase(torch, F, ln)
    torch.cuda.empty_cache()
    lap("rows 10, 10kv, 1r")
    lnb_res = ln_bwd_phase(torch, F, ln)
    bwd_res = {"layernorm_bwd": lnb_res[768, False]}
    lap("row 2+3")
    bwd_res.update(flash_bwd_phase(torch, F, fa))
    f32_err = flash_f32_phase(torch, fa)
    lap("rows 5, 6 and the f32 FA2")
    bwd_res.update(xent_phase(torch, F, fx))
    torch.cuda.empty_cache()
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    shapes = port.GPT2Model.param_shapes(types.SimpleNamespace(config=cfg))
    bwd_res["adamw_update_fused"] = adamw_phase(torch, af, shapes)
    torch.cuda.empty_cache()
    lap("rows 11-13")

    print("phase 3: serving gpt2-124m")
    model = port.GPT2Model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    prompts, new = serving_traffic(np)
    serve(torch, port, model, [prompts[0][:24], prompts[1][:40]], 4)  # warm
    counters = {"layernorm_fwd": ln.layernorm_fwd,
                "add_layernorm_fwd": ln.add_layernorm_fwd,
                "ln_fwd_triton": ln._ln_fwd_triton,
                "add_ln_fwd_triton": ln._add_ln_fwd_triton,
                "kv_write": pool_mod.kv_write,
                "kv_write_v1": pool_mod.kv_write_v1,
                "paged_attention_append": Attr(pa.paged_attention, "appends"),
                "layernorm_dx": ln.layernorm_dx,
                "layernorm_dwdb": ln.layernorm_dwdb,
                "layernorm_bwd": ln.layernorm_bwd,
                "fa2_flash_attention_fwd": fa.fa2_flash_attention_fwd,
                "fa2_flash_attention_dq": fa.fa2_flash_attention_dq,
                "fa2_flash_attention_dkv": fa.fa2_flash_attention_dkv,
                "paged_attention": pa.paged_attention,
                "fused_xent_fwd": fx.fused_xent_fwd,
                "fused_xent_dx": fx.fused_xent_dx,
                "fused_xent_dw": fx.fused_xent_dw,
                "adamw_update_fused": af.adamw_update_fused,
                "paged_attention_quant": pa.paged_attention_quant,
                "paged_attention_span": pa.paged_attention_span,
                "quantize_blockwise": qm.quantize_blockwise,
                "fa2_chunk_fwd": fa.fa2_chunk_fwd,
                "fa2_chunk_dq": fa.fa2_chunk_dq,
                "fa2_chunk_dkv": fa.fa2_chunk_dkv,
                **{k: getattr(fa, k) for k in BTHD_KERNELS},
                "rmsnorm_fwd": rn.rmsnorm_fwd,
                "add_rmsnorm_fwd": rn.add_rmsnorm_fwd,
                "rmsnorm_bwd": rn.rmsnorm_bwd,
                "rmsnorm_bwd_gs": Attr(rn.rmsnorm_bwd, "launches_gs"),
                "dropout": dr.dropout}
    serve_kernels = SERVE_BASE + ("paged_attention",
                                  "paged_attention_append")
    for fn in counters.values():
        fn.launches = 0
    eng, reqs, wall, seg, _ = serve(torch, port, model, prompts, new)
    serve_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  launches on the main path: {serve_launches}")
    # every decode launch carries its layer's append; kv_write launches
    # once a prefill (12 layers, one group)
    check(serve_launches["paged_attention_append"]
          == serve_launches["paged_attention"]
          and serve_launches["kv_write"] == seg["prefills"],
          f"phase 3: appends {serve_launches['paged_attention_append']} "
          f"against {serve_launches['paged_attention']} decode launches, "
          f"kv_write {serve_launches['kv_write']} against "
          f"{seg['prefills']} prefills")
    print(f"  kv_write.launches {serve_launches['kv_write']} (one a "
          f"prefill, {seg['prefills']} prefills), paged_attention.appends "
          f"{serve_launches['paged_attention_append']} (every decode "
          f"launch)")
    for k in serve_kernels:
        check(serve_launches[k] > 0, f"{k} was never launched on the main "
              "path")
    check(not any(serve_launches[k] for k in counters
                  if k not in serve_kernels),
          "serving ran a kernel outside its path (a backward kernel, or the "
          "quantizer that kv_write replaces)")
    statuses = [r.status for r in reqs]
    check(all(s == "ok" for s in statuses), f"statuses {statuses}")
    check(all(len(r.tokens) == new for r in reqs), "short token streams")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "token ids out of range")
    check(eng.pool.blocks_in_use == 0, "pool blocks leaked")
    # the watchdog restarts on a tick exception; on this run any restart
    # is a hidden failure
    check(eng.restarts == 0, f"{eng.restarts} warm restart(s) while serving")
    ll = eng.last_logits
    check(ll is not None and ll.shape == (8, cfg.vocab_size)
          and bool(torch.isfinite(ll).all()), "decode logits malformed")
    total = sum(len(r.tokens) for r in reqs)
    decode_tokens = total - len(reqs)
    ttft = sorted(r.t_first - r.t_arrival for r in reqs)
    decode_tps = decode_tokens / seg["decode_s"]
    print(f"  requests 16 ok, prompt lens {sorted(len(p) for p in prompts)}, "
          f"{total} tokens in {wall:.4f}s ({total / wall:.2f} tok/s "
          f"end to end); decode {decode_tokens} tokens in "
          f"{seg['decode_ticks']} ticks, {seg['decode_s']:.4f}s -> "
          f"{decode_tps:.2f} decode tok/s; prefill {seg['prefill_s']:.4f}s; "
          f"TTFT p50 {statistics.median(ttft) * 1e3:.2f} ms "
          f"(all 16 submitted at t=0)")

    kern, plain = plain_prefill_logits(torch, port, model, prompts[0])
    check(kern.shape == (1, cfg.vocab_size) and bool(
        torch.isfinite(kern).all()), "prefill logits malformed")
    scale = float(plain.abs().max())
    perr = max_err(kern, plain)
    # bf16 activations through 12 blocks: agreement to ~2% of the logit
    # scale (bf16 keeps ~3 significant digits per op)
    print(f"  first request prefill logits vs plain path on the card: "
          f"max_abs_err={perr:.4g}, max|logit|={scale:.4g} "
          f"(tol 5e-2 * max|logit|); argmax kernel "
          f"{int(kern.argmax())} plain {int(plain.argmax())}")
    check(perr <= 5e-2 * scale, "prefill logits disagree with the plain path")

    # (the append's device time lies inside the decode kernel's records)
    patterns = {k: PATTERNS[k] for k in serve_kernels if k in PATTERNS}
    for _ in range(3):  # an empty CUPTI trace: serve the traffic again
        _, _, pwall, _, prof = serve(torch, port, model, prompts, new,
                                     profile=True)
        if prof is not None:
            break
    check(prof is not None, "the profiler recorded no device time")
    per, busy, rows = kernel_shares(torch, prof, patterns)
    check_no_pair_records(rows, "phase 3's profiled pass")
    with open(os.path.join(OUT_DIR, "serving_profile.txt"), "w") as f:
        for us, n, key in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    check(busy > 0, "the profiler recorded no device time")
    # device time is the same traffic's with or without the profiler; the
    # profiled pass's own wall is inflated by tracing, so shares are over
    # the unprofiled main run's wall
    shares = {k: round(per.get(k, 0.0) / 1e6 / wall, 5) for k in patterns}
    print(f"  device time of the same traffic (profiled pass, wall "
          f"{pwall:.4f}s under tracing): busy {busy / 1e6:.4f}s = "
          f"{busy / 1e6 / wall:.4f} of the main run's {wall:.4f}s wall "
          f"(idle share {1 - busy / 1e6 / wall:.4f}); kernel share of wall "
          f"{shares}")
    for us, n, key in rows[:10]:
        print(f"    {us / 1e3:10.3f} ms x{n:<6d} {key[:90]}")
    lap("phase 3's serving runs")
    ticks = {"plain": tick_report(torch, model, prompts, counters, pool_mod,
                                  "phase 3 (bf16 pool)",
                                  arms=("fused", "apart", "triton",
                                        "unfused"))}
    lap("phase 3's decode tick")
    plain_tokens = [r.tokens for r in reqs]
    del eng, model, prof
    torch.cuda.empty_cache()

    print("phase 4: training gpt2-124m (SingleDevice)")
    train = train_phase(torch, port, counters, ln, fa, fx, af)
    check(not any(train["launches"][k] for k in KNOB_KERNELS),
          "the default training path ran a knob's kernel")
    unfused_training_check(torch, port, counters, train)
    torch.cuda.empty_cache()
    lap("phase 4")
    train["ln_bwd_ab"] = ln_bwd_step_ab(torch, port, ln)
    torch.cuda.empty_cache()
    lap("phase 4's LN backward A/B")
    print("phase 5: knobbed training gpt2-124m (fused head, fused AdamW, "
          "dropout)")
    knob = knobbed_phase(torch, port, counters, ln, fa, fx, af)
    torch.cuda.empty_cache()
    lap("phase 5")

    print("phase 6: serving variants of gpt2-124m (speculative decoding, "
          "prefix cache, int8/fp8 pools)")
    model = port.GPT2Model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    var_paths, var_res, agree = variants_phase(
        torch, np, model, counters, pa, pool_mod, qm, plain_tokens)
    f32_identity(torch, np, port, model, counters)
    lap("phase 6's serving runs")
    for mode in ("int8", "fp8"):
        ticks[mode] = tick_report(torch, model, prompts, counters, pool_mod,
                                  f"phase 6 ({mode} pool)",
                                  arms=("fused", "apart", "unfused"),
                                  quant=mode)
    torch.cuda.empty_cache()
    lap("phase 6's decode ticks")

    t7 = time.perf_counter()
    print("phase 7: distributed — the unmasked FA2 chunk kernels, ring "
          "attention over 4 virtual ranks, DDP / Zero1 / Zero2 at world 1 "
          "over NCCL")
    chunk_res = chunk_phase(torch, F, fa)
    ring_launches = ring_phase(torch, port, fa, counters, model)
    del model
    torch.cuda.empty_cache()
    with nccl_world1(torch):
        dist_res = engines_phase(torch, port, counters, train)
        torch.cuda.empty_cache()
        print(f"phase 7: {time.perf_counter() - t7:.2f}s")

        t8 = time.perf_counter()
        print("phase 8: heads-last FA2 (#7, #8) and its A/B, ZeRO-3 with "
              "the fp8 gather on gpt2-124m and gpt2-1.5b at world 1 over "
              "NCCL")
        bthd_res = bthd_phase(torch, F, fa)
        ab = ab_phase(torch, counters)
        torch.cuda.empty_cache()
        z3_res = zero3_phase(torch, port, counters, train)
        del train["params13"]
        torch.cuda.empty_cache()
        xl = zero3_xl_phase(torch, port, counters)
        torch.cuda.empty_cache()
        print(f"phase 8: {time.perf_counter() - t8:.2f}s")
        print("phases 7c and 8c on the MoE family: DDP and Zero3 (bf16, "
              "fp8 gather) at world 1 on moe-8x124m")
        moe_paths = moe_engines_phase(torch, port, counters)
        lap("7c / 8c on moe-8x124m")

        t12 = time.perf_counter()
        print(f"phase 12: the in-step collective schedule at world 1 "
              f"[{card}]")
        sched_paths = sched_engines_phase(
            torch, port, counters, train, z3_res["zero3_fp8"]["losses"],
            card)
        lap("12a, the engines")
        exec_paths, sched_res = sched_exec_phase(torch, port, counters, card)
        sched_paths.update(exec_paths)
        sched_res["hpz_1.5b"] = hpz_layout(port, card)
        print(f"phase 12: {time.perf_counter() - t12:.2f}s")

        t13 = time.perf_counter()
        print(f"phase 13: the grad-comm codecs at world 1 [{card}]")
        codec_paths = codec_engines_phase(torch, port, counters, card)
        lap("13a, the engines")
        got, qz_codec, codec_res = codec_sync_phase(torch, port, qm,
                                                    counters, card)
        codec_paths.update(got)
        lap("13b, the codec functions")
        got, exec_res = codec_exec_phase(torch, port, qm, counters, card)
        codec_paths.update(got)
        codec_res.update(exec_res)
        print(f"phase 13: {time.perf_counter() - t13:.2f}s")

        t14 = time.perf_counter()
        print(f"phase 14: Ulysses on the FA2 kernels and the counter-based "
              f"dropout kernel [{card}]")
        uly_res, uly_paths = ulysses_lockstep_phase(torch, fa, counters,
                                                    card)
        lap("14a, Ulysses over lockstep threads")
        ulysses_group_phase(torch, card)
        uly_paths.update(ulysses_engines_phase(torch, port, counters, card))
        lap("14b / 14c, the NCCL group and the engines")
        drop_res = dropout_phase(torch, F, dr, card)
        torch.cuda.empty_cache()
        print(f"phase 14: {time.perf_counter() - t14:.2f}s")

        t15 = time.perf_counter()
        print(f"phase 15: the telemetry knob and the optimizer-state "
              f"offload [{card}]")
        p15, off_res = offload_phase(torch, port, counters, card,
                                     xl["batch"])
        lap("15a, offload on gpt2-1.5b")
        got, telem_res = telemetry_phase(torch, port, counters, card)
        p15.update(got)
        lap("15b, telemetry")
        p15.update(drop_exec_phase(torch, port, counters, card))
        lap("15c, dropout through the executors")
        print(f"phase 15: {time.perf_counter() - t15:.2f}s")

    t9 = time.perf_counter()
    lap("phases 7-8")
    print("phase 9: the Llama family — RMSNorm on the LayerNorm entries' "
          "RMS flag (rows r1, r1r, r2+3, r2+3r), llama-160m served and "
          "trained")
    rms_res = rms_phase(torch, F, rn)
    lap("9a, the RMS entries")
    llama_paths, llama_serve = llama_serving_phase(
        torch, np, port, counters, pa, pool_mod, qm, rn,
        ticks["plain"]["fused"])
    lap("9b, llama-160m served")
    llama_train = llama_train_phase(torch, port, counters, rn, ln, fa, fx,
                                    af)
    llama_paths["llama_training"] = llama_train["launches"]
    lap("9c, llama-160m trained")
    print(f"phase 9: {time.perf_counter() - t9:.2f}s")

    t10 = time.perf_counter()
    print(f"phase 10: the MoE family — {MOE} trained with the einsum and "
          "the sort dispatch")
    moe_train_paths, moe_train = moe_train_phase(torch, port, counters, ln,
                                                 fa, fx, af)
    moe_paths.update(moe_train_paths)
    print(f"phase 10: {time.perf_counter() - t10:.2f}s")
    lap("phase 10")

    t11 = time.perf_counter()
    print("phase 11: generate on gpt2-124m, llama-160m and moe-8x124m (the "
          "paged decode kernel with its append over a private pool); "
          "checkpoint and resume under SingleDevice and world-1 Zero3")
    mods = {"pa": pa, "pool": pool_mod, "ln": ln, "fa": fa, "rn": rn}
    gen_paths, gen_res = gen_phase(
        torch, np, port, counters, mods,
        lambda: gen_plain_ops(pa, pool_mod, qm, rn))
    lap("11a, generate")
    ckpt_res = ckpt_phase(torch, port, train["losses13"][:6])
    lap("11b, checkpoints")
    print(f"phase 11: {time.perf_counter() - t11:.2f}s")

    timed = ("shape", "ms", "plain_ms", "library_ms", "call_ms", "bound_ms",
             "bound_by")
    extra_keys = (TURN_KEYS + UNFUSED_KEYS + PARENT_KEYS + V1_KEYS
                  + ("plain_turns_ms", "plain_turns_spread_ms"))

    def entry(name, route, source, replaces, res, err=None, training=None):
        """One row: its times at `res["shape"]`; a forward kernel that
        training runs at another shape carries those under
        `training_shape`.  `max_abs_err` is the worst of every checked
        shape."""
        by_path = {"serving": serve_launches[name],
                   "training": train["launches"][name],
                   "knobbed_training": knob["launches"][name],
                   **{p: v[name] for p, v in var_paths.items()},
                   "ring4": ring_launches[name],
                   **{p: v["launches"][name] for p, v in dist_res.items()},
                   "ab": ab["launches"][name],
                   **{p: v["launches"][name] for p, v in z3_res.items()},
                   "zero3_1.5b": xl["launches"][name],
                   **{p: v[name] for p, v in llama_paths.items()},
                   **{p: v[name] for p, v in moe_paths.items()},
                   **{p: v[name] for p, v in gen_paths.items()},
                   **{p: v[name] for p, v in sched_paths.items()},
                   **{p: v[name] for p, v in codec_paths.items()},
                   **{p: v[name] for p, v in uly_paths.items()},
                   **{p: v[name] for p, v in p15.items()}}
        row = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": res["max_abs_err"] if err is None else err,
               **{k: res[k] for k in timed}, "ms_source": clock_of(res),
               **{k: res[k] for k in extra_keys if k in res}}
        if name in f32_err:  # the f32 dispatch: the FMA kernel
            row["f32_max_abs_err"] = f32_err[name]
        if training is not None:
            row["training_shape"] = {k: training[k]
                                     for k in timed + extra_keys
                                     if k in training}
            row["training_shape"]["ms_source"] = clock_of(training)
        return row

    kernels = [
        entry("layernorm_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/ln_fwd.cu",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:78",
              ln_res[512, 768], ln_err, ln_res[8192, 768]),
        entry("fa2_flash_attention_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_fwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:381",
              fa_res["serving"], fa_err, fa_res["training"]),
        entry("paged_attention", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/paged_attn.cu",
              "tiny_deepspeed_tpu/ops/paged_attn_pallas.py:228",
              pa_res["decode"], pa_err),
        entry("paged_attention_quant", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/paged_attn.cu",
              "tiny_deepspeed_tpu/ops/paged_attn_pallas.py:228",
              pq_res["int8"], pq_err),
        entry("paged_attention_span", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/paged_attn.cu",
              "tiny_deepspeed_tpu/ops/paged_attn_pallas.py:228",
              ps_res["bf16", "spec"], ps_err),
        entry("quantize_blockwise", "triton",
              "tiny_deepspeed_tpu_torch/ops/quant.py",
              "tiny_deepspeed_tpu/ops/quant_pallas.py:59",
              qz_codec),
        # rows 2 and 3: one launch of csrc/ln_bwd.cu computes both
        entry("layernorm_bwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/ln_bwd.cu",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:132",
              bwd_res["layernorm_bwd"]),
        entry("layernorm_bwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/ln_bwd.cu",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:185",
              bwd_res["layernorm_bwd"]),
        entry("fa2_flash_attention_dq", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:281",
              bwd_res["fa2_flash_attention_dq"]),
        entry("fa2_flash_attention_dkv", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:248",
              bwd_res["fa2_flash_attention_dkv"]),
        entry("fused_xent_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/fused_xent.cu",
              "tiny_deepspeed_tpu/ops/xent_pallas.py:267",
              bwd_res["fused_xent_fwd"]),
        entry("fused_xent_dx", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/fused_xent.cu",
              "tiny_deepspeed_tpu/ops/xent_pallas.py:218",
              bwd_res["fused_xent_dx"]),
        entry("fused_xent_dw", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/fused_xent.cu",
              "tiny_deepspeed_tpu/ops/xent_pallas.py:235",
              bwd_res["fused_xent_dw"]),
        entry("adamw_update_fused", "triton",
              "tiny_deepspeed_tpu_torch/optim/adamw_fused.py",
              "tiny_deepspeed_tpu/optim/adamw_pallas.py:69",
              bwd_res["adamw_update_fused"]),
        entry("fa2_chunk_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_fwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:330",
              chunk_res["fa2_chunk_fwd"]),
        entry("fa2_chunk_dq", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:341",
              chunk_res["fa2_chunk_dq"]),
        entry("fa2_chunk_dkv", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:350",
              chunk_res["fa2_chunk_dkv"]),
        entry("fa2_flash_attention_bthd_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_fwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:630",
              bthd_res["fa2_flash_attention_bthd_fwd", 12]),
        entry("fa2_flash_attention_bthd_dkv", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:668",
              bthd_res["fa2_flash_attention_bthd_dkv", 12]),
        entry("fa2_flash_attention_bthd_dq", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:685",
              bthd_res["fa2_flash_attention_bthd_dq", 12]),
        entry("kv_write", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/kv_write.cu",
              "tiny_deepspeed_tpu/ops/quant_pallas.py:59",
              kv_res["prefill_bf16"], err=kv_err),
        entry("add_layernorm_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/ln_fwd.cu",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:78",
              aln_res[8, 768], err=aln_err, training=aln_res[8192, 768]),
        # the Triton pair rows 1 and 1r replaced: the parent's arm, off
        # every path
        entry("ln_fwd_triton", "triton",
              "tiny_deepspeed_tpu_torch/ops/layernorm.py",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:78",
              ln_tri[512, 768], ln_tri_err, ln_tri[8192, 768]),
        entry("add_ln_fwd_triton", "triton",
              "tiny_deepspeed_tpu_torch/ops/layernorm.py",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:78",
              aln_tri[8, 768], aln_tri_err, aln_tri[8192, 768]),
        # the decode kernel's APPEND instantiation: 9a/9b with the write
        # of the decode step's K/V (JAX paged_append, then attention)
        entry("paged_attention_append", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/paged_attn.cu",
              "tiny_deepspeed_tpu/ops/paged_attn_pallas.py:228",
              app_res["bf16"], err=app_err),
        # the v1 writer kernel: the new one's reference, off every path
        entry("kv_write_v1", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/kv_write.cu",
              "tiny_deepspeed_tpu/ops/quant_pallas.py:59",
              kv_v1_res["prefill_bf16"], err=kv_err),
        # rows r1, r1r, r2+3, r2+3r: RMSNorm, the LayerNorm entries under
        # their RMS flag.  No TPU kernel stands behind them: in JAX they
        # are an XLA fusion of ops/rmsnorm.py's plain functions
        *(entry(name, "cuda", f"tiny_deepspeed_tpu_torch/csrc/{src}",
                f"tiny_deepspeed_tpu/ops/rmsnorm.py:{line} (no TPU "
                "kernel: an XLA fusion)", rms_res[name, 8192, 768])
          for name, src, line in (
              ("rmsnorm_fwd", "ln_fwd.cu", 25),
              ("add_rmsnorm_fwd", "ln_fwd.cu", 25),
              ("rmsnorm_bwd", "ln_bwd.cu", 33),
              ("rmsnorm_bwd_gs", "ln_bwd.cu", 33))),
        # no TPU kernel stands behind it: JAX drops with
        # jax.random.bernoulli + where, two XLA ops
        entry("dropout", "triton", "tiny_deepspeed_tpu_torch/ops/dropout.py",
              "tiny_deepspeed_tpu/models/gpt2.py:228 (no TPU kernel: "
              "jax.random.bernoulli + where, XLA ops)", drop_res["bfloat16"]),
    ]
    kernels[13]["per_step"] = bwd_res["adamw_update_fused"]["per_step"]
    extra = {"paged_attention": {"long_context": pa_res["long_context"]},
             "paged_attention_quant": {"fp8_pool": pq_res["fp8"]},
             "paged_attention_span": {
                 "suffix": ps_res["bf16", "suffix"],
                 "int8_pool": ps_res["int8", "spec"],
                 "int8_pool_suffix": ps_res["int8", "suffix"]},
             "quantize_blockwise": dict(qz_res),
             **{k: {"b8": bthd_res[k, 8]} for k in BTHD_KERNELS},
             "kv_write": {k: kv_res[k] for k, *_ in KV_TIMED
                          if k != "prefill_bf16"},
             "kv_write_v1": {k: kv_v1_res[k] for k, *_ in KV_TIMED
                             if k != "prefill_bf16"},
             "paged_attention_append": {"int8_pool": app_res["int8"]},
             "layernorm_fwd": {"decode": ln_res[8, 768],
                               "n1600": ln_res[8192, 1600]},
             "add_layernorm_fwd": {"prefill": aln_res[512, 768],
                                   "n1600": aln_res[8192, 1600]},
             "ln_fwd_triton": {"decode": ln_tri[8, 768],
                               "n1600": ln_tri[8192, 1600]},
             "add_ln_fwd_triton": {"prefill": aln_tri[512, 768],
                                   "n1600": aln_tri[8192, 1600]},
             "layernorm_bwd": {"add": lnb_res[768, True],
                               "n1600": lnb_res[1600, False],
                               "n1600_add": lnb_res[1600, True]},
             **{k: {"decode": rms_res[k, 8, 768],
                    "n2048": rms_res[k, 8192, 2048]} for k in RMS_KERNELS},
             "dropout": {"f32": drop_res["float32"]}}
    for row in kernels:
        for k, v in extra.get(row["name"], {}).items():
            row[k + "_shape"] = {f: v[f] for f in timed + extra_keys
                                 if f in v}
            row[k + "_shape"]["ms_source"] = clock_of(v)
    clocks = [(row["name"] + ("." + k if k != "row" else ""), key, src)
              for row in kernels
              for k, part in [("row", row)] + [
                  (k, v) for k, v in row.items() if k.endswith("_shape")]
              for key, src in part["ms_source"].items()]
    events = [f"{n}:{key}" for n, key, src in clocks if src != "profiler"]
    print(f"clocks: {len(clocks) - len(events)} of {len(clocks)} device "
          f"times from the profiler, {len(events)} from CUDA events"
          + (f" ({', '.join(events)})" if events else ""))
    check(len(kernels) == 31, f"{len(kernels)} kernel rows")
    # the dropout kernel: on the dropout paths, exactly, and nowhere else
    by = kernels[30]["launches_by_path"]
    drop_paths = ("knobbed_training", "uly_drop_single",
                  *(p for p, _ in ULY_ENGINES), "drop_exec_bucket4",
                  "drop_exec_composed4")
    check(all(by[p] > 0 for p in drop_paths)
          and not any(v for p, v in by.items() if p not in drop_paths),
          f"dropout launches by path {by}")
    gpt2_paths = [p for p in kernels[0]["launches_by_path"]
                  if not is_llama_path(p)]
    for row in kernels[26:30]:
        by = row["launches_by_path"]
        want = ("llama_training",) if row["name"].startswith(
            "rmsnorm_bwd") else ("llama_serving", "llama_training", "L-gen")
        check(all(by[p] > 0 for p in want),
              f"{row['name']} was never launched on {want}: {by}")
        check(not any(by[p] for p in gpt2_paths),
              f"{row['name']} ran on a GPT-2 path: {by}")
    for row in (kernels[0], kernels[21]):  # rows 1 and 1r
        check(not any(v for p, v in row["launches_by_path"].items()
                      if is_llama_path(p)),
              f"{row['name']} ran on a Llama path")
        check(all(row["launches_by_path"][p] > 0 for p in ("gen", "M-gen")),
              f"{row['name']} never ran on a GPT-2 / MoE generate path")
    # rows 4, 9a (every launch with its append) and 10kv on every
    # generate path
    for row in (kernels[1], kernels[2], kernels[20], kernels[24]):
        check(all(row["launches_by_path"][p] > 0 for p, _ in GEN_PATHS),
              f"{row['name']} never ran on a generate path: "
              f"{row['launches_by_path']}")
    for row in kernels[14:17]:
        check(row["launches_by_path"]["ring4"] > 0,
              f"{row['name']} was never launched on the ring path")
    for row in kernels[17:20]:
        check(row["launches_by_path"]["ab"] > 0,
              f"{row['name']} was never launched on the A/B path")
    for row in kernels[20:22]:
        check(row["launches_by_path"]["serving"] > 0,
              f"{row['name']} was never launched on the serving path")
    for row in kernels[22:24] + kernels[25:26]:
        check(not any(row["launches_by_path"].values()),
              f"the replaced kernel {row['name']} ran on a path: "
              f"{row['launches_by_path']}")
    check(kernels[24]["launches_by_path"]["serving"] > 0,
          "the decode append was never launched on the serving path")
    with open(os.path.join(OUT_DIR, "variants.json"), "w") as f:
        json.dump({"results": var_res, "agreement": agree,
                   "ticks": ticks, "llama_serving": llama_serve,
                   "llama_training": {k: v for k, v in llama_train.items()
                                      if k != "launches"},
                   "moe_training": moe_train,
                   "generate": gen_res, "checkpoint": ckpt_res,
                   "schedule": sched_res, "codecs": codec_res,
                   "offload": off_res, "telemetry": telem_res},
                  f, indent=1, default=str)
    print(f"total {time.perf_counter() - t_all:.2f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
