#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Where the fused xent kernels' time goes: ablations of csrc/fused_xent.cu.

    python3 xent_ablate.py

Needs one CUDA card.  Builds variants of the kernel source with parts of
the kernels cut out, each with nvcc into
`build/xent_ablate/`, and times every variant's forward, dx and dW at the
knobbed training path's shape (S = 8192, D = 768, V = 50304, bf16) with
CUDA events (two warm-up calls, then the mean of ten).  The variants compute wrong numbers on purpose; they only
show how much time each part costs:

- base: the source as it is;
- no_epi: dx's epilogue skips exp (dz = -onehot g/S);
- no_prod: dx skips its product (dz w^T);
- no_mma: the logit recompute skips its products (all three kernels);
- no_mma_no_prod: both — what is left is staging the operands through
  shared memory, the barriers and the epilogues.

Those four cuts touch the forward, dx and the f32 dW kernel.  bf16 dW
runs the tensor-core kernel (`tc::xent_dw_wgmma`), which has its own:

- no_rec: dW skips the logit recompute (Z^T = 0);
- no_dwprod: dW skips its product (dW^T += dZ^T x);
- no_rec_no_dwprod: both — what is left is the x ring, the partial-logit
  exchange, the epilogue, the barriers and the store.

The cuts are made by text edits of the current source, so an edit of the
kernel that moves those lines makes this script fail loudly.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "xent_ablate")

# (marker in the source, its count, the text put around it) per cut
_EPI = ("        p = expf(zrow[ec + i] - lse_r);", 1,
        "#ifndef NO_EPI\n{}\n#endif")
_PROD = ("    // dx[:, chunk c] += dz w[chunk c, tile]^T: warp owns 16 "
         "columns of", 1, "#ifdef NO_PROD\n    continue;\n#endif\n{}")
_MMA = ("        M::template mma<wmma::row_major, wmma::row_major>(\n"
        "            zf[(k / M::K) & 1], xc + zr * LDX + k, LDX, wc + k * LDW "
        "+ zc,\n            LDW);", 2, "#ifndef NO_MMA\n{}\n#else\n;\n#endif")
_REC = ("          wgmma_ss_n32_ta<T>(z, desc_mn<CW>(wt(c), 2 * g + kk),\n"
        "                             desc_k<CW>(xt(st, c), 2 * g + kk), "
        "c + kk > 0);", 1, "#ifndef NO_REC\n{}\n#else\n;\n#endif")
_Z = ("    float z[16];\n", 1,
      "{}#ifdef NO_REC\n    for (int i = 0; i < 16; ++i) z[i] = 0.f;\n"
      "#endif\n")
_DWPROD = ("          wgmma_rs<T, CW>(acc[i], a[kk], desc_mn<CW>(xt(st, my0 + "
           "i), kk),\n                          1);", 1,
           "#ifndef NO_DWPROD\n{}\n#else\n;\n#endif")
VARIANTS = {"base": [], "no_epi": ["-DNO_EPI"], "no_prod": ["-DNO_PROD"],
            "no_mma": ["-DNO_MMA"], "no_mma_no_prod": ["-DNO_MMA",
                                                       "-DNO_PROD"],
            "no_rec": ["-DNO_REC"], "no_dwprod": ["-DNO_DWPROD"],
            "no_rec_no_dwprod": ["-DNO_REC", "-DNO_DWPROD"]}


def ablatable_source(src):
    for marker, count, wrap in (_EPI, _PROD, _MMA, _REC, _Z, _DWPROD):
        if src.count(marker) != count:
            raise SystemExit(f"xent_ablate: marker not found {count}x in "
                             f"fused_xent.cu: {marker.splitlines()[0]!r}")
        src = src.replace(marker, wrap.format(marker))
    return src


def main():
    import torch
    if not torch.cuda.is_available():
        print("xent_ablate: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tiny_deepspeed_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = ablatable_source(open(os.path.join(_build.CSRC,
                                             "fused_xent.cu")).read())
    cu = os.path.join(OUT, "fused_xent_ablate.cu")
    with open(cu, "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    flags += ["-I", str(_build.CSRC)]
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *flags, *defs, "-o",
         os.path.join(OUT, f"{name}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in VARIANTS.items()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"xent_ablate: {name} did not build:\n{log}")

    s, d, v = 8192, 768, 50304
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(s, d, generator=g, device="cuda").bfloat16()
    w = (torch.randn(d, v, generator=g, device="cuda") * 0.05).bfloat16()
    tg = torch.randint(0, v, (s,), generator=g, device="cuda").int()
    loss, lse = (torch.empty(s, device="cuda") for _ in range(2))
    gs = torch.full((1,), 1.0 / s, device="cuda")
    dx = torch.empty_like(x)
    dw = torch.empty(d, v, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = ctypes.c_void_p
    bf16 = _build.DTYPE_CODES[torch.bfloat16]

    def timed(fn, n=10):
        fn()
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        fns = {}
        for fn, n_ptr in (("fused_xent_fwd", 5), ("fused_xent_dx", 6),
                          ("fused_xent_dw", 6)):
            f = getattr(lib, fn)
            f.argtypes = [ptr] * n_ptr + [ctypes.c_int] * 4 + [ptr]
            fns[fn] = f
        args = {"fused_xent_fwd": (loss, lse), "fused_xent_dx": (lse, gs, dx),
                "fused_xent_dw": (lse, gs, dw)}
        ms = {fn: timed(lambda fn=fn: fns[fn](
            x.data_ptr(), w.data_ptr(), tg.data_ptr(),
            *(t.data_ptr() for t in args[fn]), s, d, v, bf16, stream))
            for fn in fns}
        print(f"{name:15s} " + " ".join(f"{k[11:]} {t:.3f} ms"
                                        for k, t in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
