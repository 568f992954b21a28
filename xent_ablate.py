#!/usr/bin/env python3
# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Where the fused xent kernels' time goes: ablations of csrc/fused_xent.cu.

    python3 xent_ablate.py

Needs one CUDA card.  Builds variants of the kernel source with parts of
the kernels cut out, each with nvcc into
`build/xent_ablate/`, and times every variant's forward, dx and dW at the
knobbed training path's shape (S = 8192, D = 768, V = 50304, bf16) with
CUDA events (two warm-up calls, then the mean of ten), the forward and dx
handed w^T as the training path hands it.  The variants compute wrong
numbers on purpose; they only show how much time each part costs:

- base: the source as it is.

The forward and dx run the tensor-core kernels for bf16
(`tc::xent_fwd_wgmma`, `tc::xent_dx_wgmma`: one device function, x
resident in shared memory at this shape); the cuts:

- no_zrec: the logit recompute skips its products (Z = 0), forward and
  dx;
- no_dxprod: dx skips its product (dx += dZ w^T);
- no_exp: the exp epilogue is cut (dx: dz = -onehot g/S; forward: the
  sum-exp adds the logits);
- no_zrec_no_dxprod: no recompute and no dx product — what is left is
  the w^T ring, the partial-logit exchange, the epilogue, the barriers
  and the stores;
- no_wload: the w^T ring copies only its first tiles (the rest compute
  on stale tiles) — what the stream of w^T from L2 costs.

dW runs `tc::xent_dw_wgmma`, which has its own:

- no_rec: dW skips the logit recompute (Z^T = 0);
- no_dwprod: dW skips its product (dW^T += dZ^T x);
- no_rec_no_dwprod: both — what is left is the x ring, the partial-logit
  exchange, the epilogue, the barriers and the store.

The cuts are made by text edits of the current source, so an edit of the
kernel that moves those lines makes this script fail loudly.

Last, a probe of the one operand that streams in the forward and dx: 128
CTAs (one per 64 tokens at S = 8192) each copy all of the head's weight
into shared memory, 32 vocab entries a tile through a two-stage cp.async
ring as the kernels do, and nothing else; once from w (D, V), where a
tile is D pieces of 64 bytes a row apart, and once from w^T (V, D),
where a tile is 32 contiguous rows.  Both move 128 x D x V x 2 bytes
(9.9 GB); CUDA events, in turns (w, w^T, w^T, w) x 3, medians.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "xent_ablate")

# (marker in the source, its count, the text put around it) per cut
_ZREC = ("          wgmma_ss_n32<T>(z, desc_k<CW>(xs(c), 2 * g + kk),\n"
         "                          desc_k<CW>(ws(st, c), 2 * g + kk), "
         "c + kk > 0);", 1, "#ifndef NO_ZREC\n{}\n#else\n;\n#endif")
_ZZ = ("    const int st = XRES ? jt % 2 : 0;\n    float z[16];\n", 1,
       "{}#ifdef NO_ZREC\n    for (int i = 0; i < 16; ++i) z[i] = 0.f;\n"
       "#endif\n")
_DXPROD = ("            wgmma_rs<T, CW>(acc[i], a[kk], desc_mn<CW>(ws(st, my0 + "
           "i), kk),\n                            1);", 1,
           "#ifndef NO_DXPROD\n{}\n#else\n;\n#endif")
_EXP_DX = ("        float p = exp2f((z[i] - lse_r[h]) * kLog2e);", 1,
           "#ifndef NO_EXP\n{}\n#else\n        float p = 0.f;\n#endif")
_EXP_FWD = ("          s += exp2f((zz[i] - mn) * kLog2e);", 1,
            "#ifndef NO_EXP\n{}\n#else\n          s += zz[i];\n#endif")
_WLOAD = ("      if (jt + 1 < ntiles) load_w(jt + 1, st ^ 1);", 1,
          "#ifndef NO_WLOAD\n{}\n#else\n      if (jt + 1 < 2) load_w(jt + 1, "
          "st ^ 1);\n#endif")
_REC = ("          wgmma_ss_n32_ta<T>(z, desc_mn<CW>(wt(c), 2 * g + kk),\n"
        "                             desc_k<CW>(xt(st, c), 2 * g + kk), "
        "c + kk > 0);", 1, "#ifndef NO_REC\n{}\n#else\n;\n#endif")
_Z = ("    // share: k-steps 2g and 2g + 1 of every chunk\n    float z[16];\n",
      1, "{}#ifdef NO_REC\n    for (int i = 0; i < 16; ++i) z[i] = 0.f;\n"
      "#endif\n")
_DWPROD = ("          wgmma_rs<T, CW>(acc[i], a[kk], desc_mn<CW>(xt(st, my0 + "
           "i), kk),\n                          1);", 1,
           "#ifndef NO_DWPROD\n{}\n#else\n;\n#endif")
# the L2 stream probe (see above); includes csrc/hopper.cuh
PROBE = r"""
#include "hopper.cuh"
using namespace tds::sm90;

template <bool WT>
__global__ void __launch_bounds__(256, 1)
stream_probe(const char* m, int D, int V, int* sink) {
  extern __shared__ __align__(128) char sm[];
  const int tile = 32 * D * 2, pieces = tile / 16, ntiles = V / 32;
  auto issue = [&](int jt) {
    const uint32_t dst = smem_u32(sm + (jt % 2) * tile);
    for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
      const char* src = WT ? m + (size_t)jt * tile + 16 * i
                           : m + (size_t)(i / 4) * V * 2 + jt * 64 + 16 * (i % 4);
      cp_async16(dst + 16 * i, src, true);
    }
    cp_async_commit();
  };
  issue(0);
  int acc = 0;
  for (int jt = 0; jt < ntiles; ++jt) {
    if (jt + 1 < ntiles) issue(jt + 1); else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    acc += sm[(jt % 2) * tile + threadIdx.x];
    __syncthreads();
  }
  if (acc == 0x7fffffff) sink[blockIdx.x] = acc;
}

extern "C" int stream_probe_run(const void* m, int D, int V, int wt,
                                int ctas, void* sink, void* stream) {
  const int smem = 2 * 32 * D * 2;
  auto k = wt ? stream_probe<true> : stream_probe<false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k<<<ctas, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(m), D, V, static_cast<int*>(sink));
  return cudaGetLastError();
}
"""

VARIANTS = {"base": [], "no_zrec": ["-DNO_ZREC"], "no_dxprod": ["-DNO_DXPROD"],
            "no_exp": ["-DNO_EXP"],
            "no_zrec_no_dxprod": ["-DNO_ZREC", "-DNO_DXPROD"],
            "no_wload": ["-DNO_WLOAD"],
            "no_rec": ["-DNO_REC"], "no_dwprod": ["-DNO_DWPROD"],
            "no_rec_no_dwprod": ["-DNO_REC", "-DNO_DWPROD"]}


def ablatable_source(src):
    for marker, count, wrap in (_ZREC, _ZZ, _DXPROD, _EXP_DX, _EXP_FWD,
                                _WLOAD, _REC, _Z, _DWPROD):
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
    probe_cu = os.path.join(OUT, "stream_probe.cu")
    with open(probe_cu, "w") as f:
        f.write(PROBE)
    builds = {**{name: (defs, cu) for name, defs in VARIANTS.items()},
              "stream_probe": ([], probe_cu)}
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *flags, *defs, "-o",
         os.path.join(OUT, f"{name}.so"), src_],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (defs, src_) in builds.items()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"xent_ablate: {name} did not build:\n{log}")

    s, d, v = 8192, 768, 50304
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(s, d, generator=g, device="cuda").bfloat16()
    w = (torch.randn(d, v, generator=g, device="cuda") * 0.05).bfloat16()
    wt = w.t().contiguous()  # the bf16 forward and dx read w^T (V, D)
    tg = torch.randint(0, v, (s,), generator=g, device="cuda").int()
    loss, lse = (torch.empty(s, device="cuda") for _ in range(2))
    gs = torch.full((1,), 1.0 / s, device="cuda")
    dx = torch.empty_like(x)
    dw = torch.empty(d, v, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = ctypes.c_void_p
    bf16 = _build.DTYPE_CODES[torch.bfloat16]

    def timed(fn, n=10):
        for _ in range(2):
            err = fn()
            if err:
                raise SystemExit(f"xent_ablate: launch refused ({err})")
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
        for fn, n_ptr in (("fused_xent_fwd_wt", 5), ("fused_xent_dx_wt", 6),
                          ("fused_xent_dw", 6)):
            f = getattr(lib, fn)
            f.argtypes = [ptr] * n_ptr + [ctypes.c_int] * 4 + [ptr]
            fns[fn] = f
        args = {"fused_xent_fwd_wt": (wt, loss, lse),
                "fused_xent_dx_wt": (wt, lse, gs, dx),
                "fused_xent_dw": (w, lse, gs, dw)}
        ms = {fn: timed(lambda fn=fn: fns[fn](
            x.data_ptr(), args[fn][0].data_ptr(), tg.data_ptr(),
            *(t.data_ptr() for t in args[fn][1:]), s, d, v, bf16, stream))
            for fn in fns}
        print(f"{name:17s} " + " ".join(
            f"{k[11:].removesuffix('_wt')} {t:.3f} ms" for k, t in ms.items()))

    probe = ctypes.CDLL(os.path.join(OUT, "stream_probe.so")).stream_probe_run
    probe.argtypes = [ptr] + [ctypes.c_int] * 4 + [ptr, ptr]
    sink = torch.zeros(128, dtype=torch.int32, device="cuda")
    runs = {0: [], 1: []}  # 0: w (D, V), 1: w^T (V, D)
    for _ in range(3):
        for layout in (0, 1, 1, 0):
            m = wt if layout else w
            runs[layout].append(timed(lambda: probe(
                m.data_ptr(), d, v, layout, 128, sink.data_ptr(), stream)))
    gb = 128 * d * v * 2 / 1e9
    for layout, name in ((0, "w (D, V), 64-byte row pieces"),
                         (1, "w^T (V, D), contiguous rows")):
        t = sorted(runs[layout])[len(runs[layout]) // 2]
        print(f"L2 stream of {name}: {t:.4f} ms [{min(runs[layout]):.4f}, "
              f"{max(runs[layout]):.4f}] for {gb:.2f} GB, "
              f"{gb / t:.3f} TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
