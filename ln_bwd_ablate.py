#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Where LayerNorm's fused backward spends its time: ablations of
csrc/ln_bwd.cu (rows 2+3).

    python3 ln_bwd_ablate.py

Needs one CUDA card.  At chip_smoke.py's shapes (8192 rows of 768 and
1600, bf16, with and without gs), each call's device time from CUDA
events around 20 calls queued behind a sleep, the median of 5 rounds in
turns (the variants in order, then reversed):

- cuts: variants of the source built with parts cut, which compute wrong
  numbers on purpose and only show what each part costs:
  - base: the source as it is;
  - no_load: the ring copies neither x nor gy (stage 1 reduces whatever
    the ring holds): the arithmetic, the stores and the fold alone;
  - no_math: the per-element arithmetic cut to one add a pass: the
    loads, the stores and the fold alone;
  - no_stage2: stage 2 (the column fold) not launched;
  - colmajor_dump: the warps' dw/db sums dumped column-major with scalar
    stores (8-way bank conflicts), the kernel's first layout;
- cold: base and the parent's sequence (the Triton pair, plus `gs + dx`)
  on four input sets in rotation (~150-200 MB, past the 50 MB L2), where
  the same-input loop above and chip_smoke.py's in-turns timing let the
  card's L2 hold part of the inputs.

The cuts are text edits of the current source, so an edit that moves
those lines makes this script fail loudly.  Variants build with nvcc
into build/ln_bwd_ablate/, in parallel.
"""

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "ln_bwd_ablate")

PASS1 = """          const float xh = xhat_of(xf[e], mean, rstd);
          const float dxh = __fmul_rn(gf[e], wf[e]);
          s1 += dxh;
          s2 = fmaf(dxh, xh, s2);
          adw[k * E + e] = fmaf(gf[e], xh, adw[k * E + e]);
          adb[k * E + e] += gf[e];"""
PASS2 = """          d[e] = dx_of(__fmul_rn(gf[e], wf[e]), xhat_of(xf[e], mean, rstd),
                       rstd, k1, k2);"""
DUMP = """#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          const int at = w_slot<E>(c, 4 * q);
          const float* u = adw + k * E + 4 * q;
          const float* v = adb + k * E + 4 * q;
          *reinterpret_cast<float4*>(mdw + at) =
              make_float4(u[0], u[1], u[2], u[3]);
          *reinterpret_cast<float4*>(mdw + K + at) =
              make_float4(v[0], v[1], v[2], v[3]);
        }"""
CUTS = {
    "no_load": [("          copy_chunk<T, E>(bx + c * E, x + r * a.sx + c * E);\n"
                 "          copy_chunk<T, E>(bx + K + c * E, gy + r * a.sgy + "
                 "c * E);\n", "")],
    "no_math": [(PASS1, "          adb[k * E + e] += gf[e] + xf[e] + wf[e];"),
                (PASS2, "          d[e] = xf[e] + gf[e] + wf[e] + k1;")],
    "no_stage2": [("  ln_bwd_cols_kernel<<<", "  if (rows >= 0) return "
                   "cudaGetLastError();\n  ln_bwd_cols_kernel<<<")],
    "colmajor_dump": [
        (DUMP, """#pragma unroll
        for (int e = 0; e < E; ++e) {
          mdw[c * E + e] = adw[k * E + e];
          mdw[K + c * E + e] = adb[k * E + e];
        }"""),
        ("    const int at = w_slot<E>(i / E, i % E);\n",
         "    const int at = i;\n")],
}


def _sub(src, old, new):
    if src.count(old) != 1:
        raise SystemExit(f"ln_bwd_ablate: expected one {old[:60]!r}... in "
                         "csrc/ln_bwd.cu; the source moved")
    return src.replace(old, new)


def build(_build):
    """{variant: its ln_bwd C entry}, all nvcc runs at once."""
    os.makedirs(OUT, exist_ok=True)
    src = (_build.CSRC / "ln_bwd.cu").read_text()
    procs = {}
    for name, edits in {"base": [], **CUTS}.items():
        s = src
        for old, new in edits:
            s = _sub(s, old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", os.path.join(OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        entries[name] = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).ln_bwd
    return entries


def queued_ms(torch, fn, n=20):
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def in_turns(torch, fns, reps=5):
    for fn in fns.values():
        fn()
    got = {k: [] for k in fns}
    for _ in range(reps):
        for k in list(fns) + list(fns)[::-1]:
            got[k].append(queued_ms(torch, fns[k]))
    return {k: statistics.median(v) for k, v in got.items()}


def main():
    import torch
    if not torch.cuda.is_available():
        print("ln_bwd_ablate: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tiny_deepspeed_tpu_torch.ops import _build
    from tiny_deepspeed_tpu_torch.ops import layernorm as ln

    entries = build(_build)
    for fn in entries.values():
        fn.argtypes, fn.restype = ln._BWD_ARGS, ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    key = ("ln_bwd", "ln_bwd")
    _build._LIBS["ln_bwd"] = None  # every call goes through _ENTRIES

    def via(name, *a):
        _build._ENTRIES[key] = entries[name]
        return ln.layernorm_bwd(*a)

    for n in (768, 1600):
        sets = []
        for seed in range(4):
            g = torch.Generator(device="cuda").manual_seed(seed)
            x = (torch.randn(8192, n, generator=g, device="cuda") * 2
                 + 0.3).bfloat16()
            w = torch.randn(n, generator=g, device="cuda").bfloat16()
            gy, gs = (torch.randn(8192, n, generator=g, device="cuda")
                      .bfloat16() for _ in range(2))
            _, mean, rstd = ln._ln_fwd_plain(x, w, w)
            sets.append((gy, x, w, mean, rstd, gs))
        gy, x, w, mean, rstd, gs = sets[0]
        for add in (False, True):
            g = gs if add else None
            want = ln._ln_bwd_plain(gy, x, w, mean, rstd, g)
            got = via("base", gy, x, w, mean, rstd, g)
            err = max(float((a.float() - b.float()).abs().max())
                      / float(b.float().abs().max())
                      for a, b in zip(got, want))
            if err > 2e-2:
                raise SystemExit(f"ln_bwd_ablate: base disagrees ({err})")
            fns = {name: (lambda name=name: via(name, gy, x, w, mean, rstd,
                                                g)) for name in entries}
            rot = [0]

            def rotate(fn):
                def call():
                    rot[0] = (rot[0] + 1) % 4
                    s = sets[rot[0]]
                    return fn(*s[:5], s[5] if add else None)
                return call

            def parent(gy_, x_, w_, mean_, rstd_, gs_):
                dx = ln.layernorm_dx(gy_, x_, w_, mean_, rstd_)
                if gs_ is not None:
                    dx = gs_ + dx
                return dx, *ln.layernorm_dwdb(gy_, x_, mean_, rstd_)

            fns["cold base"] = rotate(lambda *s: via("base", *s))
            fns["parent"] = lambda: parent(gy, x, w, mean, rstd, g)
            fns["cold parent"] = rotate(parent)
            ms = in_turns(torch, fns)
            print(f"8192x{n} bf16{' +gs' if add else ''}: "
                  + ", ".join(f"{k} {v:.5g} ms" for k, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
