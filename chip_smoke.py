#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""On-card smoke of the PyTorch port: build, check and time its kernels,
serve gpt2-124m through ServingEngine, then train it through SingleDevice.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels compile for sm_90a) and exits
non-zero, printing no result, without one.  Phases, each on its own line:

  1. the card (`nvidia-smi` name and power limit) and the kernel build —
     nvcc for csrc/*.cu (in parallel) plus the Triton layernorm's first
     compile;
  2. kernel parity: each hand-written kernel against its plain PyTorch
     version on the card at its main paths' shapes (the two forward
     kernels at serving's and at training's), in bf16, with the
     tolerance stated per kernel; the four backward kernels also run
     twice and must agree bit for bit.  Its device time (profiler) stands
     beside the plain version's, one library call's (timed here as a
     yardstick only; the port never calls it) and the bound — the larger
     of bytes / 3.35 TB/s and flops / the H100 SXM dense peak for the
     inputs' type — and `call_ms` is its per-call time with host launch
     overhead (CUDA events around back-to-back calls);
  3. serving: gpt2-124m (seeded random weights, bf16 compute) under
     ServingEngine(max_active=8, block_tokens=16) with a pool sized for
     the traffic — 16 greedy requests, seeded prompt lengths 16-512, 64
     new tokens each.  Every kernel's launch count is zeroed just before
     and read just after; each serving kernel must be non-zero.  The first
     request's prefill logits are checked against the plain path on the
     card.  A second, profiled pass of the same traffic gives each
     kernel's device time, reported as a share of the (unprofiled) main
     run's wall;
  4. training: gpt2-124m at full width and depth (f32 masters, bf16
     compute, remat "dots_no_batch"), SingleDevice + AdamW(lr=1e-5,
     weight_decay=0.1) on the JAX package's synthetic stream, B=8,
     T=1024: 3 warm-up steps, then 10 timed steps with every count zeroed
     just before and read just after (each training kernel non-zero);
     finite losses, the first near ln(50304); one step's gradients on the
     kernel path against the plain path on the card; remat on and off
     bit-identical; 8 steps at lr=1e-3 on one batch lower its loss; one
     profiled step gives each kernel's device time and the device's busy
     and idle shares;
  5. the `kernels` JSON line, then the result line
     {"ok": true, "device": {"platform": "gpu", ...}}.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import dataclasses
import json
import math
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


def device_ms(torch, fn, iters=20, warmup=3):
    """Mean DEVICE time per call: every kernel the call launches, summed
    from the profiler's CUDA activity over `iters` calls.  Unlike
    `time_ms` it excludes host launch overhead, which dominates at decode
    shapes.  Fails if the profiler stays empty: no other clock stands in
    for it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    prof = profiled(torch, run, tries=5)
    check(prof is not None, "the profiler recorded no device time in 5 "
          "tries")
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if getattr(e, "device_type", None) == cuda)
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

def checked_ln_fwd(torch, ln, x, w, b):
    """layernorm_fwd on the card against its plain version: (y, mean,
    rstd) and y's max abs err.  bf16 y: the stats agree to f32 rounding,
    so y agrees to ~1 bf16 ulp (atol 2e-2, rtol 1.6e-2)."""
    y, mean, rstd = ln.layernorm_fwd(x, w, b)
    torch.cuda.synchronize()
    py, pmean, prstd = ln._ln_fwd_plain(x, w, b)
    torch.testing.assert_close(y.float(), py.float(), atol=2e-2,
                               rtol=1.6e-2)
    torch.testing.assert_close(mean, pmean, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(rstd, prstd, atol=1e-5, rtol=1e-4)
    return y, mean, rstd, max_err(y, py)


def layernorm_phase(torch, F, ln):
    """Serving's shapes (8 decode rows, a 512-token prefill) and
    training's (B*T = 8192 rows)."""
    rows_all, n, res = (8, 512, 8192), 768, {}
    worst = 0.0
    for rows in rows_all:
        g = torch.Generator(device="cuda").manual_seed(rows)
        x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 0.3
             ).bfloat16()
        w = torch.randn(n, generator=g, device="cuda").bfloat16()
        b = torch.randn(n, generator=g, device="cuda").bfloat16()
        *_, err = checked_ln_fwd(torch, ln, x, w, b)
        worst = max(worst, err)
        nbytes = rows * n * 2 * 2 + 2 * n * 2 + rows * 8
        bms, by = bound_ms(nbytes, 8 * rows * n, "f32")
        res[rows] = dict(
            **timings(torch, lambda: ln.layernorm_fwd(x, w, b),
                      lambda: ln._ln_fwd_plain(x, w, b),
                      lambda: F.layer_norm(x, (n,), w, b)),
            bound_ms=bms, bound_by=by, max_abs_err=err,
            shape=f"{rows}x{n} bf16")
        print(f"kernel layernorm_fwd rows={rows} N={n} bf16: "
              f"max_abs_err={err:.3g} (tol atol=2e-2 rtol=1.6e-2) "
              + " ".join(f"{k}={v:.5g}" for k, v in res[rows].items()
                         if k.endswith("ms")))
    return {"serving": res[512], "training": res[8192]}, worst


def checked_fa2_fwd(torch, fa, q, k, v):
    """fa2_flash_attention_fwd on the card against its plain version:
    (o, lse) and o's max abs err.  The plain version rounds probabilities
    to bf16 before PV; the kernel keeps them f32: outputs agree to a few
    bf16 ulps (atol = rtol = 2e-2; lse atol 2e-3, rtol 1e-4)."""
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
        bms, by = bound_ms(nbytes, flops, "bf16")
        res[b, t] = dict(
            **timings(torch, lambda: fa.fa2_flash_attention_fwd(q, k, v),
                      lambda: fa._fa2_fwd_plain(q, k, v),
                      lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=True)),
            bound_ms=bms, bound_by=by, max_abs_err=err,
            shape=f"B={b} H={h} T={t} Dh={d} bf16")
        print(f"kernel fa2_flash_attention_fwd B={b} H={h} T={t} Dh={d} "
              f"bf16: max_abs_err={err:.3g} (tol atol=rtol=2e-2; lse 2e-3) "
              + " ".join(f"{k}={v:.5g}" for k, v in res[b, t].items()
                         if k.endswith("ms")))
    return {"serving": res[1, 1024], "training": res[8, 1024]}, worst


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
        bound_ms=bms, bound_by=by, max_abs_err=worst,
        shape=f"S={s} Hq={hq} Dh={d} bt={bt} pos<=1000 bf16")
    print(f"kernel paged_attention S={s} Hq={hq} Dh={d} bt={bt} "
          f"pos={pos.tolist()} bf16: max_abs_err={worst:.3g} "
          "(tol atol=rtol=2e-2) "
          + " ".join(f"{k}={v:.5g}" for k, v in res.items()
                     if k.endswith("ms")))
    return res, worst


def _rel_err(a, b):
    """max abs err of a against b, and that over max |b|."""
    err = max_err(a, b)
    return err, err / max(float(b.float().abs().max()), 1e-30)


def _bitwise(torch, fn, what):
    first, second = fn(), fn()
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(first, second)),
          f"{what}: two runs are not bit-identical")


def ln_bwd_phase(torch, F, ln):
    """ln_dx and ln_dwdb at the training path's shape: rows = B*T = 8192,
    N = 768, bf16.  Tolerance: max abs err <= 2e-2 x max |plain|."""
    rows, n = 8192, 768
    g = torch.Generator(device="cuda").manual_seed(11)
    x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 0.3
         ).bfloat16()
    w = torch.randn(n, generator=g, device="cuda").bfloat16()
    b = torch.randn(n, generator=g, device="cuda").bfloat16()
    gy = torch.randn(rows, n, generator=g, device="cuda").bfloat16()
    # the forward's stats feed both backward versions: held to theirs first
    _, mean, rstd, _ = checked_ln_fwd(torch, ln, x, w, b)
    dx = ln.layernorm_dx(gy, x, w, mean, rstd)
    dw, db = ln.layernorm_dwdb(gy, x, mean, rstd)
    torch.cuda.synchronize()
    pdx = ln._ln_dx_plain(gy, x, w, mean, rstd)
    pdw, pdb = ln._ln_dwdb_plain(gy, x, mean, rstd)
    dx_err, dx_rel = _rel_err(dx, pdx)
    dwdb = [_rel_err(dw, pdw), _rel_err(db, pdb)]
    dwdb_err = max(e for e, _ in dwdb)
    dwdb_rel = max(r for _, r in dwdb)
    check(dx_rel <= 2e-2 and dwdb_rel <= 2e-2,
          f"ln backward disagrees with its plain version: dx rel "
          f"{dx_rel:.3g}, dw/db rel {dwdb_rel:.3g}")
    _bitwise(torch, lambda: [ln.layernorm_dx(gy, x, w, mean, rstd)],
             "ln_dx")
    _bitwise(torch, lambda: ln.layernorm_dwdb(gy, x, mean, rstd), "ln_dwdb")

    # the yardstick for both passes: the autograd backward of F.layer_norm
    xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
    yr = F.layer_norm(xr, (n,), wr, br)

    def library():
        return torch.autograd.grad(yr, (xr, wr, br), gy, retain_graph=True)

    lib_ms = device_ms(torch, library)
    # bytes: each input read once, each output written once
    dx_bytes = 3 * rows * n * 2 + n * 2 + rows * 8
    dwdb_bytes = 2 * rows * n * 2 + rows * 8 + 2 * n * 2
    res = {}
    for name, kernel, plain, nbytes, flops, err, rel in (
            ("layernorm_dx", lambda: ln.layernorm_dx(gy, x, w, mean, rstd),
             lambda: ln._ln_dx_plain(gy, x, w, mean, rstd), dx_bytes,
             11 * rows * n, dx_err, dx_rel),
            ("layernorm_dwdb", lambda: ln.layernorm_dwdb(gy, x, mean, rstd),
             lambda: ln._ln_dwdb_plain(gy, x, mean, rstd), dwdb_bytes,
             5 * rows * n, dwdb_err, dwdb_rel)):
        bms, by = bound_ms(nbytes, flops, "f32")
        res[name] = dict(ms=device_ms(torch, kernel),
                         plain_ms=device_ms(torch, plain),
                         library_ms=lib_ms, call_ms=time_ms(torch, kernel),
                         bound_ms=bms, bound_by=by, max_abs_err=err,
                         shape=f"{rows}x{n} bf16")
        print(f"kernel {name} rows={rows} N={n} bf16: max_abs_err="
              f"{err:.3g} ({rel:.3g} of max|plain|; tol 2e-2) bitwise "
              "repeatable; library = F.layer_norm backward, both passes; "
              + " ".join(f"{k}={v:.5g}" for k, v in res[name].items()
                         if k.endswith("ms")))
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
        bms, by = bound_ms(nbytes, flops, "bf16")
        res[name] = dict(ms=device_ms(torch, kernel, iters=5),
                         plain_ms=device_ms(torch, plain, iters=5),
                         library_ms=lib_ms,
                         call_ms=time_ms(torch, kernel, iters=5),
                         bound_ms=bms, bound_by=by,
                         max_abs_err=max(errs[1024][key][0],
                                         errs[1000][key][0]),
                         shape=f"B={b} H={h} T={t} Dh={d} bf16")
        print(f"kernel {name} B={b} H={h} T={t} Dh={d} bf16: max_abs_err="
              f"{res[name]['max_abs_err']:.3g} (T=1024 and T=1000; tol 2e-2 "
              "x max|plain|); library = SDPA causal backward, both passes; "
              + " ".join(f"{k}={v:.5g}" for k, v in res[name].items()
                         if k.endswith("ms")))
    return res


# -- phase 3: serving ------------------------------------------------------

def serving_traffic(np):
    """16 greedy requests, prompt lengths drawn from 16-512 (seed 0), and
    the 64 new tokens each asks for."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 513, size=16)
    return [rng.integers(0, 50257, size=int(n)).tolist() for n in lens], 64


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
        prof = profiled(torch, lambda: eng.drain(max_ticks=10_000),
                        cpu=True, tries=1)
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


# -- phase 4: training -------------------------------------------------------

TRAIN_KERNELS = ("layernorm_fwd", "layernorm_dx", "layernorm_dwdb",
                 "fa2_flash_attention_fwd", "fa2_flash_attention_dq",
                 "fa2_flash_attention_dkv")
# profiler kernel-name fragments of each hand-written kernel
PATTERNS = {"layernorm_fwd": "_ln_fwd_kernel",
            "layernorm_dx": "_ln_dx_kernel",
            "layernorm_dwdb": "_ln_dwdb_",
            "fa2_flash_attention_fwd": "flash_fwd_kernel",
            "fa2_flash_attention_dq": "flash_dq_kernel",
            "fa2_flash_attention_dkv": "flash_dkv_kernel",
            "paged_attention": "paged_decode_kernel"}


@contextlib.contextmanager
def plain_ops(ln, fa):
    """Every training kernel wrapper swapped for its plain version (the
    autograd Functions look their wrappers up at call time)."""
    names = ((ln, "layernorm_fwd", ln._ln_fwd_plain),
             (ln, "layernorm_dx", ln._ln_dx_plain),
             (ln, "layernorm_dwdb", ln._ln_dwdb_plain),
             (fa, "fa2_flash_attention_fwd", fa._fa2_fwd_plain),
             (fa, "fa2_flash_attention_dq", fa._fa2_dq_plain),
             (fa, "fa2_flash_attention_dkv", fa._fa2_dkv_plain))
    saved = [(m, n, getattr(m, n)) for m, n, _ in names]
    try:
        for m, n, plain in names:
            setattr(m, n, plain)
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def loss_and_grads(torch, model, batch):
    idx, tgt = (torch.as_tensor(a, device="cuda").long() for a in batch)
    loss = model.apply(idx, tgt)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


def train_phase(torch, port, counters, ln, fa):
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
    times = []
    for _ in range(10):
        batch = loader.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = eng.step(state, batch)
        losses.append(float(loss))  # the host sync that ends the step
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  launches on the main path (10 steps): {launches}")
    for k in TRAIN_KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the main path")
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

    batch = loader.next()

    def one_step():
        float(eng.step(state, batch)[1])

    prof = profiled(torch, one_step, cpu=True)  # a retry steps again
    check(prof is not None, "the profiler recorded no device time")
    per, busy, rows = kernel_shares(torch, prof, PATTERNS)
    # cuBLAS's kernels: "*gemm*" and, on Hopper, "nvjet_*"
    gemm = sum(us for us, _, key in rows
               if "gemm" in key.lower() or key.startswith("nvjet"))
    with open(os.path.join(OUT_DIR, "train_profile.txt"), "w") as f:
        for us, n, key in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    check(busy > 0, "the profiler recorded no device time")
    step_ms = {k: per.get(k, 0.0) / 1e3 for k in TRAIN_KERNELS}
    print(f"  one profiled step: device busy {busy / 1e3:.3f} ms = "
          f"{busy / 1e3 / (med * 1e3):.4f} of the median step wall "
          f"(idle share {1 - busy / 1e6 / med:.4f}); cuBLAS GEMMs "
          f"{gemm / 1e3:.3f} ms ({gemm / busy:.4f} of busy)")
    for k in TRAIN_KERNELS:
        print(f"    {k}: {step_ms[k]:.4f} ms per step "
              f"({per.get(k, 0.0) / busy:.4f} of busy)")
    for us, n, key in rows[:12]:
        print(f"    {us / 1e3:10.3f} ms x{n:<6d} {key[:90]}")

    # one step's gradients: kernel path vs plain path, remat on vs off
    batch = loader.next()
    kl, kg = loss_and_grads(torch, model, batch)
    before = {k: fn.launches for k, fn in counters.items()}
    with plain_ops(ln, fa):
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
                busy_ms=busy / 1e3, first_loss=losses[0])


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
    bwd_res = ln_bwd_phase(torch, F, ln)
    bwd_res.update(flash_bwd_phase(torch, F, fa))

    print("phase 3: serving gpt2-124m")
    cfg = port.GPT2_PRESETS["gpt2-124m"]
    model = port.GPT2Model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    prompts, new = serving_traffic(np)
    serve(torch, port, model, [prompts[0][:24], prompts[1][:40]], 4)  # warm
    counters = {"layernorm_fwd": ln.layernorm_fwd,
                "layernorm_dx": ln.layernorm_dx,
                "layernorm_dwdb": ln.layernorm_dwdb,
                "fa2_flash_attention_fwd": fa.fa2_flash_attention_fwd,
                "fa2_flash_attention_dq": fa.fa2_flash_attention_dq,
                "fa2_flash_attention_dkv": fa.fa2_flash_attention_dkv,
                "paged_attention": pa.paged_attention}
    serve_kernels = ("layernorm_fwd", "fa2_flash_attention_fwd",
                     "paged_attention")
    for fn in counters.values():
        fn.launches = 0
    eng, reqs, wall, seg, _ = serve(torch, port, model, prompts, new)
    serve_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  launches on the main path: {serve_launches}")
    for k in serve_kernels:
        check(serve_launches[k] > 0, f"{k} was never launched on the main "
              "path")
    check(not any(serve_launches[k] for k in counters
                  if k not in serve_kernels), "serving ran a backward kernel")
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

    patterns = {k: PATTERNS[k] for k in serve_kernels}
    for _ in range(3):  # an empty CUPTI trace: serve the traffic again
        _, _, pwall, _, prof = serve(torch, port, model, prompts, new,
                                     profile=True)
        if prof is not None:
            break
    check(prof is not None, "the profiler recorded no device time")
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
    del eng, model, prof
    torch.cuda.empty_cache()

    print("phase 4: training gpt2-124m (SingleDevice)")
    train = train_phase(torch, port, counters, ln, fa)

    timed = ("shape", "ms", "plain_ms", "library_ms", "call_ms", "bound_ms",
             "bound_by")

    def entry(name, route, source, replaces, res, err=None, training=None):
        """One row: its times at `res["shape"]`; a forward kernel that
        training runs at another shape carries those under
        `training_shape`.  `max_abs_err` is the worst of every checked
        shape."""
        by_path = {"serving": serve_launches[name],
                   "training": train["launches"][name]}
        row = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": res["max_abs_err"] if err is None else err,
               **{k: res[k] for k in timed}}
        if training is not None:
            row["training_shape"] = {k: training[k] for k in timed}
        return row

    kernels = [
        entry("layernorm_fwd", "triton",
              "tiny_deepspeed_tpu_torch/ops/layernorm.py",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:78",
              ln_res["serving"], ln_err, ln_res["training"]),
        entry("fa2_flash_attention_fwd", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_fwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:381",
              fa_res["serving"], fa_err, fa_res["training"]),
        entry("paged_attention", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/paged_attn.cu",
              "tiny_deepspeed_tpu/ops/paged_attn_pallas.py:228",
              pa_res, pa_err),
        entry("layernorm_dx", "triton",
              "tiny_deepspeed_tpu_torch/ops/layernorm.py",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:132",
              bwd_res["layernorm_dx"]),
        entry("layernorm_dwdb", "triton",
              "tiny_deepspeed_tpu_torch/ops/layernorm.py",
              "tiny_deepspeed_tpu/ops/layernorm_pallas.py:185",
              bwd_res["layernorm_dwdb"]),
        entry("fa2_flash_attention_dq", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:281",
              bwd_res["fa2_flash_attention_dq"]),
        entry("fa2_flash_attention_dkv", "cuda",
              "tiny_deepspeed_tpu_torch/csrc/flash_bwd.cu",
              "tiny_deepspeed_tpu/ops/flash_fa2.py:248",
              bwd_res["fa2_flash_attention_dkv"]),
    ]
    print(f"phase 5: total {time.perf_counter() - t_all:.2f}s")
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
