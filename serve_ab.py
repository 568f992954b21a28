#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Interleaved serving A/B of checkouts of the PyTorch port, on one card.

    python3 serve_ab.py ROOT [ROOT ...] [--rounds 2] [--reps 3]

Each ROOT is a checkout that holds `tiny_deepspeed_tpu_torch/` (this
repo's root, or another commit unpacked with `git archive` into a
git-ignored directory such as `build/`).  Every checkout serves
chip_smoke.py's phase-3 traffic (gpt2-124m with seeded random weights,
ServingEngine(max_active=8, block_tokens=16), 16 greedy requests with
seeded prompt lengths 16-512, 64 new tokens each) in a fresh process of
its own, in the order A B .. B A per round, so that a drift of the host
over the call falls on every checkout alike.  A process builds its
checkout's kernels (cached under ROOT/build/kernels; all checkouts are
built at once first), serves two short warm-up requests, then the traffic
`--reps` times, and prints one JSON line per run: decode tokens/s, TTFT
p50, the wall, and a digest of the generated tokens (same weights, greedy
sampling: every checkout must produce the same tokens).  The last line
holds each checkout's runs and their median.  Needs one CUDA card.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from tiny_deepspeed_tpu_torch.ops import _build; _build.build_all()")


def _smoke():
    """chip_smoke.py beside this script (its `serve` and traffic), loaded
    by path so that ROOT's own copy never shadows it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root, reps):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import tiny_deepspeed_tpu_torch as port
    smoke = _smoke()
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    model = port.GPT2Model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    prompts, new = smoke.serving_traffic(np)
    smoke.serve(torch, port, model, [prompts[0][:24], prompts[1][:40]], 4)
    for rep in range(reps):
        eng, reqs, wall, seg, _ = smoke.serve(torch, port, model, prompts,
                                              new)
        smoke.check(all(r.status == "ok" and len(r.tokens) == new
                        for r in reqs), "a request did not finish")
        toks = json.dumps([r.tokens for r in reqs]).encode()
        ttft = statistics.median(r.t_first - r.t_arrival for r in reqs)
        decode_tokens = sum(len(r.tokens) for r in reqs) - len(reqs)
        print(json.dumps({
            "root": root, "rep": rep,
            "decode_tok_s": decode_tokens / seg["decode_s"],
            "ttft_p50_ms": ttft * 1e3, "wall_s": wall,
            "decode_s": seg["decode_s"], "prefill_s": seg["prefill_s"],
            "decode_ticks": seg["decode_ticks"],
            "tokens_sha1": hashlib.sha1(toks).hexdigest()[:12]}),
            flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts to compare")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of A B .. B A (default 2)")
    ap.add_argument("--reps", type=int, default=3,
                    help="runs of the traffic per process (default 3)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        return child(roots[0], args.reps)
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, r])
              for r in roots]
    if any(p.wait() for p in builds):
        print("serve_ab: a kernel build failed", file=sys.stderr)
        return 1
    order = []
    for _ in range(args.rounds):
        order += roots + roots[::-1]
    runs = {r: [] for r in roots}
    for r in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--reps",
             str(args.reps), r], capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            if line.startswith('{"root"'):
                print(line, flush=True)
                runs[r].append(json.loads(line))
    digests = {rec["tokens_sha1"] for rs in runs.values() for rec in rs}
    print(json.dumps({"same_tokens": len(digests) == 1, "checkouts": [
        {"root": r, "decode_tok_s": [x["decode_tok_s"] for x in rs],
         "decode_tok_s_median": statistics.median(
             x["decode_tok_s"] for x in rs),
         "ttft_p50_ms_median": statistics.median(
             x["ttft_p50_ms"] for x in rs)} for r, rs in runs.items()]}))
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
