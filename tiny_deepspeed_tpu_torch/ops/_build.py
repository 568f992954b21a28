# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Build and load the hand-written CUDA kernels (no JAX counterpart).

Each `csrc/*.cu` source compiles with nvcc into its own shared library
with a plain C interface, loaded through `ctypes` — no PyTorch headers,
so a build takes seconds, not minutes.  Libraries land in
`<repo>/build/kernels/` (git-ignored), named by a hash of the source and
the flags: an edited source rebuilds, an unchanged one loads the cached
library.  The first call builds EVERY source, one nvcc process each, all
started together.

Nothing here runs at import: the CPU tests import every module of the
port on hosts that have neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

# dtype codes of the C interface (csrc/common.cuh tds::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# ... and the KV pool's resting types, quantized ones included
POOL_CODES = {**DTYPE_CODES, torch.int8: 3, torch.float8_e4m3fn: 4}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[tuple, object] = {}
# seconds the last build_all() spent in nvcc (0.0 when every library
# was already cached) — chip_smoke.py reports it
last_build_s = 0.0
# {source name: nvcc output} of the last build: ptxas' register, shared
# memory and spill counts per kernel (-Xptxas=-v)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = [os.path.join(home, "bin", "nvcc")] if home else []
    cand += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cand:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "compiled from csrc/ at first use")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):  # every source includes them
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every csrc/*.cu not already built (in parallel), load all
    of them, and return {source stem: CDLL}.  Raises with nvcc's output
    when a source does not compile."""
    global last_build_s
    with _LOCK:
        if _LIBS:
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        srcs = sorted(CSRC.glob("*.cu"))
        todo = [(s, _lib_path(s)) for s in srcs
                if not _lib_path(s).exists()]
        t0 = time.perf_counter()
        if todo:
            nvcc = _nvcc()
            procs = []
            for src, out in todo:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            errors = []
            for src, out, tmp, p in procs:
                log, _ = p.communicate()
                build_logs[src.name] = log
                if p.returncode != 0:
                    errors.append(f"{src.name}:\n{log}")
                    continue
                os.replace(tmp, out)  # atomic: readers never see half a file
            if errors:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        last_build_s = time.perf_counter() - t0
        for s in srcs:
            _LIBS[s.stem] = ctypes.CDLL(str(_lib_path(s)))
        return _LIBS


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (building all on the
    first call)."""
    return build_all()[name]


def entry(lib: str, name: str, argtypes: Sequence):
    """The C function `name` of csrc/<lib>.cu with its argtypes declared
    (pointers and the stream as c_void_p: an undeclared pointer would be
    cut to 32 bits) and an int (cudaError_t) result."""
    key = (lib, name)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(library(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the kernels launch on it:
    its raw handle (a `torch.cuda.Stream` object costs the host ~4 us a
    call on the H100 machine, the handle ~0.1)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t (a
    refused launch never runs, and a later synchronize would not say)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
