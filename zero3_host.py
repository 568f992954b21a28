#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Where ZeRO-3's host time goes at world 1 on one card.

    python3 zero3_host.py

ZeRO-3 gathers each layer's weights inside the block's checkpoint
(tiny_deepspeed_tpu_torch/parallel/zero3.py), so its steps issue ~440
collectives on gpt2-124m where SingleDevice issues none, and under the
selective remat policy every op of those gathers also passes through the
checkpoint's dispatch mode.  This script separates the two, on
gpt2-124m at B=8 T=1024 over a one-rank NCCL group, in two processes —
the second with `TORCH_NCCL_TRACE_BUFFER_SIZE=0`, which turns off NCCL's
flight recorder (read when the group is created):

- the host and device time of one 3.5 MB bf16 all-gather (300 calls);
- the median of 5 step times of SingleDevice and of Zero3 under remat
  "dots_no_batch" (the default, selective) and "nothing" (whole-block
  recompute, no dispatch mode), each without and with
  `gather_quant="fp8"`;
- for each Zero3 arm, the parts of its fp8 cost that run outside the
  backward, as the medians of 20 timed calls (synchronized): the step's
  `prepare` (the non-block gathers and the block shards' cast, or their
  absmax, all-reduce MAX and quantization) and the gathers of one layer
  (`layer`; a step runs them twice per layer, forward and recompute).

Prints one JSON line per process; exits non-zero without a card.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _timed(fn, n=20):
    """The median of n synchronized calls of fn, in ms."""
    import torch
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def measure():
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import tiny_deepspeed_tpu_torch as port
    store = os.path.join(ROOT, "build", "zero3_host", f"store{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    out = {"trace_buffer": os.environ.get("TORCH_NCCL_TRACE_BUFFER_SIZE",
                                          "default")}
    try:
        x = torch.randn(1769472, device="cuda").bfloat16()
        y = torch.empty_like(x)
        for _ in range(20):
            dist.all_gather_into_tensor(y, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(300):
            dist.all_gather_into_tensor(y, x)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["all_gather_host_us"] = host / 300 * 1e6
        out["all_gather_us"] = (time.perf_counter() - t0) / 300 * 1e6
        cfg = port.GPT2_PRESETS["gpt2-124m"]
        for quant in (None, "fp8"):
            for name, policy in (("SingleDevice", "dots_no_batch"),
                                 ("Zero3", "dots_no_batch"),
                                 ("Zero3", "nothing")):
                model = port.GPT2Model(dataclasses.replace(
                    cfg, remat_policy=policy, gather_quant=quant))
                eng = getattr(port, name)(model, port.AdamW(
                    lr=1e-5, weight_decay=0.1))
                state = eng.init(0)
                loader = port.TokenLoader(None, batch=8, seq=1024,
                                          vocab_size=cfg.vocab_size, seed=0)
                key = f"{name}_{policy}" + ("_fp8" if quant else "")
                times = []
                for i in range(8):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    float(eng.step(state, loader.next())[1])
                    if i >= 3:
                        times.append(time.perf_counter() - t0)
                out[key + "_step_ms"] = statistics.median(times) * 1e3
                if name == "Zero3":
                    z3 = eng.pctx.gather
                    with torch.no_grad():
                        _, stacked = z3.prepare(state.params)
                        bp = {k: v[0] for k, v in stacked.items()}
                        out[key + "_prepare_ms"] = _timed(
                            lambda: z3.prepare(state.params))
                        out[key + "_layer_gather_ms"] = _timed(
                            lambda: z3.layer(bp))
                    del stacked, bp
                del eng, state, model
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("zero3_host: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    for env in ({}, {"TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}):
        subprocess.run([sys.executable, __file__, "--measure"], check=True,
                        env={**os.environ, **env}, timeout=600)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--measure"]:
        measure()
    else:
        sys.exit(main())
