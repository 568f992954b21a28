# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""LayerNorm's forward and its residual-add variant behind one C entry
(`ops/layernorm.layernorm_fwd` / `add_layernorm_fwd`, csrc/ln_fwd.cu on
the card) on the CPU, where they take their plain versions.

The plain versions are held against the Pallas kernel they replace,
`ln_fwd_pallas` (interpret mode, as the JAX tests run it; at row counts
no row block of 8 or more divides, the XLA version the JAX package
dispatches to there instead), and the add variant against JAX's `x + r`
then that kernel, on numpy-seeded f32 inputs at 1e-5.  On a CUDA tensor
the public wrappers call the CUDA entry's wrappers and never the Triton
pair it replaced; CPU calls count no launch; `_ln_fwd_cuda` /
`_add_ln_fwd_cuda` refuse each bad operand with ValueError before
anything is built (no nvcc here); and the ctypes argtypes declared for
the LayerNorm C entries match the parameter lists in their sources — a
mismatch would otherwise show only on the card, as a crash.  The card
holds the kernels to these plain versions and to the Triton pair's bits
(tests/test_torch_cuda.py -k ln_fwd, chip_smoke.py).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.layernorm_pallas as JLN
from tiny_deepspeed_tpu.ops.layernorm import _ln_fwd_xla
from tiny_deepspeed_tpu_torch.ops import layernorm

TOL = dict(atol=1e-5, rtol=1e-5)
CSRC = Path(layernorm.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JLN, "INTERPRET", True)


def _jax_fwd(x, w, b):
    """The JAX package's forward for x: its Pallas kernel where a row
    block divides the rows, else its XLA version."""
    jx = jnp.asarray(x)
    if JLN.pallas_supported(jx):
        return JLN.ln_fwd_pallas(jx, jnp.asarray(w), jnp.asarray(b))
    return _ln_fwd_xla(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)


def _operands(rows, n, seed):
    rng = np.random.default_rng(seed)
    x, r = ((rng.standard_normal((rows, n)) * 3 + 0.5).astype(np.float32)
            for _ in range(2))
    w, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    return x, r, w, b


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [8, 96, 770])
@pytest.mark.parametrize("rows", [1, 7, 64, 130])
def test_forward_matches_jax(rows, n):
    x, _, w, b = _operands(rows, n, rows * 1000 + n)
    jy, jmean, jrstd = _jax_fwd(x, w, b)
    y, mean, rstd = layernorm.layernorm_fwd(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), **TOL)


@pytest.mark.parametrize("rows,n", [(8, 768), (40, 96), (7, 770)])
def test_add_variant_matches_jax(rows, n):
    """s = x + r and the norm of s, against JAX adding and then calling
    its forward kernel."""
    x, r, w, b = _operands(rows, n, rows + n)
    js = jnp.asarray(x) + jnp.asarray(r)
    jy, jmean, jrstd = _jax_fwd(np.asarray(js), w, b)
    s, y, mean, rstd = layernorm.add_layernorm_fwd(_t(x), _t(r), _t(w),
                                                   _t(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for got, want in ((y, jy), (mean, jmean), (rstd, jrstd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bad_operands():
    x = torch.zeros(4, 8)
    w = torch.ones(8)
    return {
        "f64": ((x.double(), w, w), "f32/bf16/f16"),
        "int": ((x.int(), w, w), "f32/bf16/f16"),
        "n zero": ((torch.zeros(4, 0), torch.ones(0), torch.ones(0)),
                   r"not in \[1, 16384\]"),
        "n too wide": ((torch.zeros(1, 16385), torch.ones(16385),
                        torch.ones(16385)), r"not in \[1, 16384\]"),
        "weight shape": ((x, torch.ones(7), w), "weight/bias"),
        "bias shape": ((x, w, torch.ones(4, 2)), "weight/bias"),
        "weight dtype": ((x, w.double(), w), "weight/bias"),
        "cpu": ((x, w, w), "CUDA device"),
    }


@pytest.mark.parametrize("fn", ["_ln_fwd_cuda", "_add_ln_fwd_cuda"])
@pytest.mark.parametrize("case", list(_bad_operands()))
def test_cuda_wrappers_refuse_bad_operands(case, fn):
    """Each check raises ValueError with its own message before anything
    is built: on this host (no nvcc) a build would raise RuntimeError."""
    (x, w, b), match = _bad_operands()[case]
    args = (x, w, b) if fn == "_ln_fwd_cuda" else (x, x, w, b)
    with pytest.raises(ValueError, match=match):
        getattr(layernorm, fn)(*args)


@pytest.mark.parametrize("r", [torch.zeros(4, 9), torch.zeros(3, 8),
                               torch.zeros(4, 8).half()],
                         ids=["columns", "rows", "dtype"])
def test_add_wrapper_refuses_a_mismatched_r(r):
    with pytest.raises(ValueError, match="r .* must match x"):
        layernorm._add_ln_fwd_cuda(torch.zeros(4, 8), r, torch.ones(8),
                                   torch.ones(8))


def _counters():
    return (layernorm.layernorm_fwd, layernorm.add_layernorm_fwd,
            layernorm._ln_fwd_triton, layernorm._add_ln_fwd_triton)


def test_cpu_calls_count_no_launches():
    before = [f.launches for f in _counters()]
    x, r, w, b = (_t(a) for a in _operands(8, 64, 3))
    layernorm.layernorm_fwd(x, w, b)
    layernorm.add_layernorm_fwd(x, r, w, b)
    s, y = layernorm.add_layernorm(x.requires_grad_(), r, w, b)
    (s.sum() + layernorm.layernorm(y, w, b).sum()).backward()
    assert [f.launches for f in _counters()] == before


@pytest.mark.parametrize("entry", ["layernorm_fwd", "add_layernorm_fwd",
                                   "layernorm", "add_layernorm"])
def test_cuda_tensors_route_to_the_cuda_entry(entry, monkeypatch):
    """With `on_cuda` true, the wrappers (and the autograd Functions'
    forwards through them) call `_ln_fwd_cuda` / `_add_ln_fwd_cuda` once
    and never the Triton pair."""
    calls = []

    def spy(name, plain):
        def fn(*a):
            calls.append(name)
            return plain(*a)
        return fn

    def refuse(*a, **k):
        raise AssertionError("a forward called the Triton pair")

    monkeypatch.setattr(layernorm, "on_cuda", lambda *t: True)
    monkeypatch.setattr(layernorm, "_ln_fwd_cuda",
                        spy("ln", layernorm._ln_fwd_plain))
    monkeypatch.setattr(layernorm, "_add_ln_fwd_cuda",
                        spy("add", layernorm._add_ln_fwd_plain))
    monkeypatch.setattr(layernorm, "_ln_fwd_triton", refuse)
    monkeypatch.setattr(layernorm, "_add_ln_fwd_triton", refuse)
    x, r, w, b = (_t(a) for a in _operands(6, 32, 5))
    fn = getattr(layernorm, entry)
    if entry.startswith("add"):
        out = fn(x, r, w, b)
        assert calls == ["add"] and len(out) == (4 if "fwd" in entry else 2)
    else:
        out = fn(x, w, b)
        assert calls == ["ln"]
    assert all(torch.isfinite(t).all() for t in out)


# ctypes.c_longlong is c_long where both are 8 bytes: keyed by the type
_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_longlong: "long long",
          ctypes.c_int: "int", ctypes.c_float: "float"}


def _c_params(source, name):
    """The kinds of the C entry's parameters: pointer, long long, int or
    float, in order."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"{name} not found in {source}"
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        kinds.append("pointer" if "*" in p else
                     "long long" if p.startswith("long long") else
                     p.split()[0])
    return kinds


@pytest.mark.parametrize("source,name,argtypes", [
    ("ln_fwd.cu", "ln_fwd", layernorm._FWD_ARGS),
    ("ln_bwd.cu", "ln_bwd", layernorm._BWD_ARGS)])
def test_argtypes_match_the_c_entry(source, name, argtypes):
    assert [_KINDS[t] for t in argtypes] == _c_params(source, name)

