# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""A/B: heads-last FA2 against transpose + the standard FA2 kernels.

    python -m tiny_deepspeed_tpu_torch.fa2_bthd_ab [--device cpu]

Counterpart of `scripts/fa2_bthd_ab.py`.  The model's attention takes
(B, T, H, Dh) activations from the qkv projection; the default path
transposes them to (B, H, T, Dh) for the FA2 kernels and transposes o
back.  `fa2_flash_attention_bthd` reads the heads-last layout directly.
Both arms run forward and backward of sum(o^2) with respect to q, k and v
at gpt2-124m's attention shape (B=12 H=12 T=1024 Dh=64 bf16, seeded):

- "transpose+fa2": transpose q/k/v, `FA2Fn`, transpose o back — every one
  of the eight per-layer copies the model pays (three inputs and o, in
  the forward and again in the backward);
- "bthd_fa2": `FA2BthdFn` on the heads-last tensors.

Prints one JSON line per arm: `fb_ms`, the median of 30 timed
forward+backward calls (CUDA events on the card; on the CPU, which runs
the plain versions, the host clock), and `first_call_s`, the
first call's wall (on the card it includes building the kernels from
csrc/ when they are not cached; `nvcc_s` is that build alone).  Unlike
the JAX script an arm's failure is not caught: the run exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from .ops import _build
from .ops.dispatch import resolve_device
from .ops.flash_fa2 import FA2Fn, fa2_flash_attention_bthd

SHAPE = dict(batch=12, heads=12, seq=1024, head_dim=64)


def arm_transpose(q, k, v):
    """sum(o^2) through transpose + FA2Fn + transpose back."""
    o = FA2Fn.apply(q.transpose(1, 2).contiguous(),
                    k.transpose(1, 2).contiguous(),
                    v.transpose(1, 2).contiguous())
    o = o.transpose(1, 2).contiguous()
    return o.float().square().sum()


def arm_bthd(q, k, v):
    """sum(o^2) through the heads-last entry."""
    o = fa2_flash_attention_bthd(q, k, v)
    return o.float().square().sum()


ARMS = {"transpose+fa2": arm_transpose, "bthd_fa2": arm_bthd}


def inputs(device, batch, heads, seq, head_dim, dtype=torch.bfloat16,
           seed=0):
    """Seeded (B, T, H, Dh) q, k, v that require grad."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(batch, seq, heads, head_dim, generator=g,
                        device=device).to(dtype).requires_grad_()
            for _ in range(3)]


def fwd_bwd(arm, q, k, v):
    """One forward + backward: (loss, dq, dk, dv), the grads laid out
    (B, T, H, Dh) in memory as the model's qkv backward reads them (the
    transpose arm's come back as transposed views: copied here)."""
    loss = arm(q, k, v)
    return (loss, *(g.contiguous()
                    for g in torch.autograd.grad(loss, (q, k, v))))


def time_arm(arm, q, k, v, iters):
    """(median fb ms, first call s) of `iters` timed calls."""
    cuda = q.device.type == "cuda"
    t0 = time.perf_counter()
    fwd_bwd(arm, q, k, v)
    if cuda:
        torch.cuda.synchronize()
    first = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fwd_bwd(arm, q, k, v)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            fwd_bwd(arm, q, k, v)
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), first


def run(device=None, iters=30, **shape):
    """Time both arms; returns one dict per arm (also printed as JSON)."""
    device = resolve_device(device)
    shape = {**SHAPE, **shape}
    q, k, v = inputs(device, **shape)
    out = []
    for name, arm in ARMS.items():
        fb_ms, first = time_arm(arm, q, k, v, iters)
        row = {"arm": name, "fb_ms": fb_ms, "first_call_s": first,
               "nvcc_s": _build.last_build_s, "device": str(device),
               **shape, "dtype": "bfloat16", "iters": iters}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tiny_deepspeed_tpu_torch.fa2_bthd_ab",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (the plain versions)")
    run(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
