#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Where paged attention's time goes: ablations of csrc/paged_attn.cu.

    python3 paged_ablate.py

Needs one CUDA card.  Two sweeps at chip_smoke.py's shapes — decode over
bf16 and int8 pools (S=8, Hq=12, Dh=64, bt=16, W=64, pos up to 1000),
span verify at the speculative shape (K1=5, FMA kernel) and at the
suffix-prefill shape (S=2, K1=256, pos0 512 / 0, tensor cores) over the
same pools — each call's device time from CUDA events around 20 calls
queued behind a sleep, the median of 5, the layer rotating as in
chip_smoke.py:

- splits: the kernels as they are, with the split count forced to 1, 2,
  4 and 8 (the host's `split_plan` patched), beside the plan's own;
- cuts: variants of the source built with parts cut, which compute wrong
  numbers on purpose and only show what each part costs:
  - base: the source as it is;
  - empty: every kernel returns as it starts (the launch);
  - no_load: the cp.async ring copies nothing (the folds read whatever
    the ring holds);
  - no_merge: no cluster merge — rank 0 writes its own partial, no
    cluster barrier;
  - no_load_no_merge: both.

The cuts are text edits of the current source, so an edit that moves
those lines makes this script fail loudly.  Variants build with nvcc
into build/paged_ablate/, in parallel.
"""

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "paged_ablate")
CUTS = {"base": (), "empty": ("EMPTY",), "no_load": ("LOAD",),
        "no_merge": ("MERGE",), "no_load_no_merge": ("LOAD", "MERGE")}


def _sub(src, old, new, count):
    if src.count(old) != count:
        raise SystemExit(f"paged_ablate: expected {count} x {old!r} in "
                         "csrc/paged_attn.cu; the source moved")
    return src.replace(old, new)


def cut_source(src):
    """The source with PAGED_CUT_EMPTY / _LOAD / _MERGE hooks (0 or 1)."""
    s = _sub(src, "float sl2) {\n",
             "float sl2) {\n  if (PAGED_CUT_EMPTY) return;\n", 3)
    s = _sub(s, "  auto issue = [&](int t, int st) {\n",
             "  auto issue = [&](int t, int st) {\n"
             "    if (PAGED_CUT_LOAD) return;\n", 3)
    own = ("  if (PAGED_CUT_MERGE) {\n    __syncthreads();\n"
           "    if (rank == 0)\n"
           "      for (int e = threadIdx.x; e < nvalid * D; e += THREADS)\n"
           "        out[e] = tds::from_f<TO>(pacc[e] / pl[e / D]);\n"
           "    return;\n  }\n")
    s = _sub(s, "  cl.sync();  // every rank's partial is in place\n",
             own + "  cl.sync();  // every rank's partial is in place\n", 1)
    s = _sub(s, "  __syncthreads();  // the CTA's partial is complete\n",
             own + "  __syncthreads();  // the CTA's partial is complete\n",
             1)
    return ("#define PAGED_CUT_EMPTY 0\n#define PAGED_CUT_LOAD 0\n"
            "#define PAGED_CUT_MERGE 0\n" + s)


def build(_build):
    """nvcc every variant in parallel -> {name: library path}."""
    os.makedirs(OUT, exist_ok=True)
    src = cut_source((_build.CSRC / "paged_attn.cu").read_text())
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for c in cuts:
            text = text.replace(f"#define PAGED_CUT_{c} 0",
                                f"#define PAGED_CUT_{c} 1")
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"{name}.so")
        flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *flags, "-I", str(_build.CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"paged_ablate: nvcc {name} failed:\n"
                             f"{log[-3000:]}")
        libs[name] = so
    return libs


def shapes(torch, cs, pool_mod):
    """(name, view, page, q, span_kv) at chip_smoke's paged shapes."""
    out = []
    for mode in (None, "int8"):
        view, tables, pos, g = cs._decode_inputs(torch, pool_mod, mode)
        page = pool_mod.page_ref(tables, pos, 16)
        pool = mode or "bf16"

        def rand(*shape):
            return torch.randn(*shape, generator=g,
                               device="cuda").bfloat16()
        out.append((f"decode {pool}", view, page, rand(8, 12, 1, 64), None))
        out.append((f"spec {pool}", view, page, rand(8, 12, 5, 64),
                    (rand(8, 12, 5, 64), rand(8, 12, 5, 64))))
        suffix = pool_mod.page_ref(
            tables[:2], torch.tensor([512, 0], dtype=torch.int32,
                                     device="cuda"), 16)
        out.append((f"suffix {pool}", view, suffix, rand(2, 12, 256, 64),
                    (rand(2, 12, 256, 64), rand(2, 12, 256, 64))))
    return out


def time_all(so, sweep):
    """Times of every shape on library `so` (one process per library:
    the port loads one paged_attn library)."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from tiny_deepspeed_tpu_torch.ops import _build
    from tiny_deepspeed_tpu_torch.ops import paged_attn as pa
    from tiny_deepspeed_tpu_torch.serving import pool as pool_mod
    _build._LIBS["paged_attn"] = ctypes.CDLL(so)
    plan = pa.split_plan
    nxt = cs._layer_cycle(12)
    for name, view, page, q, span in shapes(torch, cs, pool_mod):
        row = []
        for n in (None, 1, 2, 4, 8) if sweep else (None,):
            pa.split_plan = plan if n is None else (
                lambda n=n, **kw: plan(**kw)._replace(splits=n))

            def call():
                return pa.paged_attention(q, view, page, nxt(), span_kv=span)
            call()
            torch.cuda.synchronize()
            row.append(statistics.median(cs._queued_ms(torch, call, 20)
                                         for _ in range(5)))
        pa.split_plan = plan
        print(f"  {name}: " + (
            "plan {:.5g}, splits 1/2/4/8 {:.5g} {:.5g} {:.5g} {:.5g}"
            if sweep else "{:.5g}").format(*row) + " ms", flush=True)


def main():
    if len(sys.argv) == 3:  # a child: time one library
        time_all(sys.argv[1], sys.argv[2] == "sweep")
        return 0
    import torch
    if not torch.cuda.is_available():
        print("paged_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tiny_deepspeed_tpu_torch.ops import _build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build(_build)
    for name, so in libs.items():
        sweep = name == "base"
        print(f"{name}" + (" (the plan's split count, then forced)"
                           if sweep else "") + ":", flush=True)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), so,
                            "sweep" if sweep else "cut"], timeout=600)
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
