#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""On-card smoke of the PyTorch port: build, check and time its kernels,
then serve gpt2-124m through ServingEngine.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels compile for sm_90a) and exits
non-zero, printing no result, without one.  Phases, each on its own line:

  1. the card (`nvidia-smi` name and power limit) and the kernel build —
     nvcc for csrc/*.cu (in parallel) plus the Triton layernorm's first
     compile;
  2. kernel parity: each hand-written kernel against its plain PyTorch
     version on the card at the serving path's shapes, in bf16, with the
     tolerance stated per kernel.  Its device time (profiler) stands
     beside the plain version's, one library call's (timed here as a
     yardstick only; the port never calls it) and the bound — the larger
     of bytes / 3.35 TB/s and flops / the H100 SXM dense peak for the
     inputs' type — and `call_ms` is its per-call time with host launch
     overhead (CUDA events around back-to-back calls);
  3. serving: gpt2-124m (seeded random weights, bf16 compute) under
     ServingEngine(max_active=8, block_tokens=16) with a pool sized for
     the traffic — 16 greedy requests, seeded prompt lengths 16-512, 64
     new tokens each.  Every kernel's launch count is zeroed just before
     and read just after; each must be non-zero.  The first request's
     prefill logits are checked against the plain path on the card.  A
     second, profiled pass of the same traffic gives each kernel's device
     time, reported as a share of the (unprofiled) main run's wall;
  4. the `kernels` JSON line, then the result line
     {"ok": true, "device": {"platform": "gpu", ...}}.

Imports nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM published peaks (dense), the bound's denominators
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes, flops, kind="bf16"):
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


def device_ms(torch, fn, iters=20, warmup=3):
    """Mean DEVICE time per call: every kernel the call launches, summed
    from the profiler's CUDA activity over `iters` calls.  Unlike
    `time_ms` it excludes host launch overhead, which dominates at decode
    shapes."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if getattr(e, "device_type", None) == cuda)
    check(us > 0, "the profiler recorded no device time")
    return us / 1e3 / iters


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


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# -- phase 2: kernel parity -------------------------------------------------

def layernorm_phase(torch, F, ln):
    rows_all, n, res = (8, 512), 768, {}
    worst = 0.0
    for rows in rows_all:
        g = torch.Generator(device="cuda").manual_seed(rows)
        x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 0.3
             ).bfloat16()
        w = torch.randn(n, generator=g, device="cuda").bfloat16()
        b = torch.randn(n, generator=g, device="cuda").bfloat16()
        y, mean, rstd = ln.layernorm_fwd(x, w, b)
        torch.cuda.synchronize()
        py, pmean, prstd = ln._ln_fwd_plain(x, w, b)
        # bf16 y: stats agree to f32 rounding, so y agrees to ~1 bf16 ulp
        torch.testing.assert_close(y.float(), py.float(), atol=2e-2,
                                   rtol=1.6e-2)
        torch.testing.assert_close(mean, pmean, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(rstd, prstd, atol=1e-5, rtol=1e-4)
        err = max_err(y, py)
        worst = max(worst, err)
        nbytes = rows * n * 2 * 2 + 2 * n * 2 + rows * 8
        bms, by = bound_ms(nbytes, 8 * rows * n, "f32")
        res[rows] = dict(
            **timings(torch, lambda: ln.layernorm_fwd(x, w, b),
                      lambda: ln._ln_fwd_plain(x, w, b),
                      lambda: F.layer_norm(x, (n,), w, b)),
            bound_ms=bms, bound_by=by, max_abs_err=err)
        print(f"kernel layernorm_fwd rows={rows} N={n} bf16: "
              f"max_abs_err={err:.3g} (tol atol=2e-2 rtol=1.6e-2) "
              + " ".join(f"{k}={v:.5g}" for k, v in res[rows].items()
                         if k.endswith("ms")))
    return res[512], worst


def flash_phase(torch, F, fa):
    res, worst = {}, 0.0
    h, d = 12, 64
    for t in (64, 512, 1024):
        g = torch.Generator(device="cuda").manual_seed(t)
        q, k, v = (torch.randn(1, h, t, d, generator=g, device="cuda"
                               ).bfloat16() for _ in range(3))
        o, lse = fa.fa2_flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        po, plse = fa._fa2_fwd_plain(q, k, v)
        # the plain version rounds probabilities to bf16 before PV; the
        # kernel keeps them f32: outputs agree to a few bf16 ulps
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)
        check(torch.isfinite(o).all().item(), "flash output not finite")
        err = max_err(o, po)
        worst = max(worst, err)
        nbytes = 4 * h * t * d * 2 + h * t * 4
        flops = 4 * h * d * t * (t + 1) / 2
        bms, by = bound_ms(nbytes, flops, "bf16")
        res[t] = dict(
            **timings(torch, lambda: fa.fa2_flash_attention_fwd(q, k, v),
                      lambda: fa._fa2_fwd_plain(q, k, v),
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=True)),
            bound_ms=bms, bound_by=by, max_abs_err=err)
        print(f"kernel fa2_flash_attention_fwd B=1 H={h} T={t} Dh={d} bf16: "
              f"max_abs_err={err:.3g} (tol atol=rtol=2e-2; lse 2e-3) "
              + " ".join(f"{k}={v:.5g}" for k, v in res[t].items()
                         if k.endswith("ms")))
    return res[1024], worst


def paged_phase(torch, F, pa, pool_mod):
    s, hq, d, bt, nl, w = 8, 12, 64, 16, 12, 64
    pos = torch.tensor([1000, 3, 15, 16, 517, 999, 0, 250],
                       dtype=torch.int32, device="cuda")
    nb = s * w
    g = torch.Generator(device="cuda").manual_seed(7)
    kp = torch.randn(nb + 1, bt, nl, hq, d, generator=g, device="cuda"
                     ).bfloat16()
    vp = torch.randn(nb + 1, bt, nl, hq, d, generator=g, device="cuda"
                     ).bfloat16()
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
    bms, by = bound_ms(nbytes, 4 * live * hq * d, "bf16")
    # rotate the layer so each call reads other pool bytes (one layer's
    # live K/V is ~24 MB; 12 layers overflow the 50 MB L2 as decode does)
    it = {"l": 0}

    def nxt():
        it["l"] = (it["l"] + 1) % nl
        return it["l"]

    mask = (torch.arange(w * bt, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]

    def library():
        ck, cv = pool_mod.paged_panel(view, nxt(), page)
        return F.scaled_dot_product_attention(q, ck, cv, attn_mask=mask)

    res = dict(
        **timings(torch, lambda: pa.paged_attention(q, view, page, nxt()),
                  lambda: pa._paged_attention_plain(q, view, page, nxt()),
                  library),
        bound_ms=bms, bound_by=by, max_abs_err=worst)
    print(f"kernel paged_attention S={s} Hq={hq} Dh={d} bt={bt} "
          f"pos={pos.tolist()} bf16: max_abs_err={worst:.3g} "
          "(tol atol=rtol=2e-2) "
          + " ".join(f"{k}={v:.5g}" for k, v in res.items()
                     if k.endswith("ms")))
    return res, worst


# -- phase 3: serving ------------------------------------------------------

def plain_prefill_logits(torch, port, model, prompt):
    """The first request's prefill logits through every kernel's plain
    version on the card (the module-level ops the model calls swapped
    for their plain versions), next to the kernel path's."""
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    from tiny_deepspeed_tpu_torch.ops.flash_fa2 import _fa2_fwd_plain
    from tiny_deepspeed_tpu_torch.ops.layernorm import _ln_fwd_plain
    from tiny_deepspeed_tpu_torch.ops.paged_attn import paged_attention
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
        pool = PagedKVPool(n_layer=c.n_layer, kv_heads=c.n_head,
                           head_dim=c.head_dim, num_blocks=bucket // bt,
                           block_tokens=bt, dtype=torch.bfloat16,
                           device="cuda")
        return model.paged_prefill(idx, p - 1, ids, pool.view, bt)[0]

    before = paged_attention.launches
    kern = run()
    saved = gpt2_mod.layernorm, gpt2_mod.ATTENTION
    gpt2_mod.layernorm = lambda x, w, b, eps=1e-5: _ln_fwd_plain(
        x, w, b, eps)[0]
    gpt2_mod.ATTENTION = {k: (lambda q, k_, v: _fa2_fwd_plain(q, k_, v)[0])
                          for k in saved[1]}
    try:
        plain = run()
    finally:
        gpt2_mod.layernorm, gpt2_mod.ATTENTION = saved
    check(paged_attention.launches == before, "prefill ran decode kernels")
    return kern, plain


def serve(torch, port, model, prompts, new, profile=False):
    from tiny_deepspeed_tpu_torch.serving import ServeConfig, ServingEngine
    longest = max(len(p) for p in prompts) + new
    per_req = -(-longest // 16) + 1
    cfg = ServeConfig(max_active=8, block_tokens=16,
                      num_blocks=8 * per_req, max_seq_tokens=longest)
    eng = ServingEngine(model, cfg)
    seg = {"prefill_s": 0.0, "decode_s": 0.0, "decode_ticks": 0}
    pre, dec = eng._prefill_step, eng._decode_plain

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

    eng._prefill_step, eng._decode_plain = timed_prefill, timed_decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new) for p in prompts]
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            eng.drain(max_ticks=10_000)
            torch.cuda.synchronize()
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
        for name, pat in patterns.items():
            if pat in e.key:
                per[name] = per.get(name, 0.0) + us
    rows.sort(reverse=True)
    return per, busy, rows


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
    from tiny_deepspeed_tpu_torch.ops import layernorm as ln
    from tiny_deepspeed_tpu_torch.ops import paged_attn as pa
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
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    t = time.perf_counter()
    x = torch.randn(4, 768, device="cuda", dtype=torch.bfloat16)
    ln.layernorm_fwd(x, torch.ones(768, device="cuda", dtype=torch.bfloat16),
                     torch.zeros(768, device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    print(f"phase 1: nvcc build {_build.last_build_s:.2f}s (csrc/*.cu, in "
          f"parallel); triton layernorm first compile "
          f"{time.perf_counter() - t:.2f}s")

    print("phase 2: kernel parity on the card (bf16)")
    ln_res, ln_err = layernorm_phase(torch, F, ln)
    fa_res, fa_err = flash_phase(torch, F, fa)
    pa_res, pa_err = paged_phase(torch, F, pa, pool_mod)

    print("phase 3: serving gpt2-124m")
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    model = port.GPT2Model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 513, size=16)
    prompts = [rng.integers(0, 50257, size=int(n)).tolist() for n in lens]
    new = 64
    serve(torch, port, model, [prompts[0][:24], prompts[1][:40]], 4)  # warm
    counters = {"layernorm_fwd": ln.layernorm_fwd,
                "fa2_flash_attention_fwd": fa.fa2_flash_attention_fwd,
                "paged_attention": pa.paged_attention}
    for fn in counters.values():
        fn.launches = 0
    eng, reqs, wall, seg, _ = serve(torch, port, model, prompts, new)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  launches on the main path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} was never launched on the main path")
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
    print(f"  requests 16 ok, prompt lens {sorted(int(n) for n in lens)}, "
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

    patterns = {"layernorm_fwd": "_ln_fwd_kernel",
                "fa2_flash_attention_fwd": "flash_fwd_kernel",
                "paged_attention": "paged_decode_kernel"}
    _, _, pwall, _, prof = serve(torch, port, model, prompts, new,
                                 profile=True)
    per, busy, rows = kernel_shares(torch, prof, patterns)
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

    def entry(name, route, source, replaces, res, err):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res["library_ms"], "call_ms": res["call_ms"]}

    kernels = [
        entry("layernorm_fwd", "triton",
              "tiny_deepspeed_tpu_torch/ops/layernorm.py",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:78",
              ln_res, ln_err),
        entry("fa2_flash_attention_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_fwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:381",
              fa_res, fa_err),
        entry("paged_attention", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/paged_attn.cu",
              "tiny_deepspeed_tpu/ops/paged_attn_pallas.py:228",
              pa_res, pa_err),
    ]
    print(f"phase 4: total {time.perf_counter() - t_all:.2f}s")
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
