# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""LayerNorm's whole backward in one call (`ops/layernorm.layernorm_bwd`,
csrc/ln_bwd.cu on the card) on the CPU, where it takes `_ln_bwd_plain`.

The plain version is held against the two Pallas kernels it replaces,
`ln_dx_pallas` and `ln_dwdb_pallas` (interpret mode, as the JAX tests
run them; at 1 and 7 rows, which no row block of 8 or more divides, the
XLA versions the JAX package dispatches to there instead), on
numpy-seeded inputs at f32: dx to 1e-5, dw/db to
1e-5 * sqrt(rows) (sums over `rows` terms; the two sides differ in
summation order only).  The add variant (`gs`, AddLayerNormFn's
upstream gradient of s = x + r) is held against `jax.vjp` through JAX's
add and custom-vjp layernorm with cotangents (g_s, g_y) at 1e-5.  Both
autograd Functions route their backward through `layernorm_bwd` (never
the Triton pair's wrappers), the gs variant's dx is `gs + dx` bit for
bit, the outputs take x's / w's / b's dtypes, and `_ln_bwd_cuda` refuses
each bad operand with ValueError before anything is built (no nvcc
here).  The card holds the kernel to this plain version
(tests/test_torch_cuda.py -k ln_bwd, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.layernorm_pallas as JLN
from tiny_deepspeed_tpu.ops.layernorm import (_ln_dwdb_xla, _ln_dx_xla,
                                              _ln_fwd_xla)
from tiny_deepspeed_tpu.ops.layernorm import layernorm as jax_layernorm
from tiny_deepspeed_tpu_torch.ops import layernorm

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JLN, "INTERPRET", True)


def _pallas(x):
    """The JAX package's choice for x: its Pallas kernels where a row
    block divides the rows (`pallas_supported`), else its XLA versions."""
    return JLN.pallas_supported(jnp.asarray(x))


def _operands(rows, n, seed):
    """x, w, b, gy, gs (f32 numpy) and the forward's mean, rstd (JAX)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * 3 + 0.5).astype(np.float32)
    w, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    gy, gs = (rng.standard_normal((rows, n)).astype(np.float32)
              for _ in range(2))
    fwd = JLN.ln_fwd_pallas if _pallas(x) else (
        lambda *a: _ln_fwd_xla(*a, 1e-5))
    _, mean, rstd = fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return x, w, b, gy, gs, np.asarray(mean), np.asarray(rstd)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [8, 64, 96, 768])
@pytest.mark.parametrize("rows", [1, 7, 64, 130])
def test_plain_matches_pallas(rows, n):
    x, w, _, gy, _, mean, rstd = _operands(rows, n, rows * 1000 + n)
    assert _pallas(x) == (rows >= 8)
    dx_fn, dwdb_fn = ((JLN.ln_dx_pallas, JLN.ln_dwdb_pallas) if _pallas(x)
                      else (_ln_dx_xla, _ln_dwdb_xla))
    jdx = dx_fn(jnp.asarray(gy), jnp.asarray(x), jnp.asarray(w),
                jnp.asarray(mean), jnp.asarray(rstd))
    jdw, jdb = dwdb_fn(jnp.asarray(gy), jnp.asarray(x), jnp.asarray(mean),
                       jnp.asarray(rstd))
    dx, dw, db = layernorm.layernorm_bwd(_t(gy), _t(x), _t(w), _t(mean),
                                         _t(rstd))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    for got, ref in ((dw, jdw), (db, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-5 * rows ** 0.5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(12, 64), (3, 5, 96), (1, 768)],
                         ids=["rows", "batched", "one-row"])
def test_add_variant_matches_jax_vjp(shape):
    """x, r, w, b gradients of (s, y) = (x + r, layernorm(x + r)) under
    cotangents (g_s, g_y): torch autograd through `add_layernorm` (whose
    backward is one `layernorm_bwd` call with gs) against jax.vjp."""
    rng = np.random.default_rng(sum(shape))
    n = shape[-1]
    x, r, gs, gy = ((rng.standard_normal(shape) * 2 + 0.3)
                    .astype(np.float32) for _ in range(4))
    w, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))

    def f(x_, r_, w_, b_):
        s = x_ + r_
        return s, jax_layernorm(s, w_, b_)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, r, w, b)))
    jg = vjp((jnp.asarray(gs), jnp.asarray(gy)))
    leaves = [_t(a).requires_grad_() for a in (x, r, w, b)]
    s, y = layernorm.add_layernorm(*leaves)
    got = torch.autograd.grad((s, y), leaves, (_t(gs), _t(gy)))
    for g, ref in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gs_variant_is_gs_plus_dx(dtype):
    x, w, _, gy, gs, mean, rstd = _operands(37, 96, 5)
    x, gy, gs = (_t(a).to(dtype) for a in (x, gy, gs))
    args = (gy, x, _t(w).to(dtype), _t(mean), _t(rstd))
    plain = layernorm.layernorm_bwd(*args)
    with_gs = layernorm.layernorm_bwd(*args, gs)
    assert torch.equal(with_gs[0], gs + plain[0])
    assert torch.equal(with_gs[1], plain[1]) and torch.equal(with_gs[2],
                                                            plain[2])


@pytest.mark.parametrize("fn", ["layernorm", "add_layernorm"])
def test_functions_route_through_layernorm_bwd(fn, monkeypatch):
    """LayerNormFn and AddLayerNormFn call `layernorm_bwd` once a
    backward (looked up at call time), with gs only from the add; the
    Triton pair's wrappers are not called."""
    calls = []
    real = layernorm.layernorm_bwd

    def spy(*a):
        calls.append(a[5] is not None)
        return real(*a)

    def refuse(*a, **k):
        raise AssertionError("the backward called the Triton pair's wrapper")

    monkeypatch.setattr(layernorm, "layernorm_bwd", spy)
    monkeypatch.setattr(layernorm, "layernorm_dx", refuse)
    monkeypatch.setattr(layernorm, "layernorm_dwdb", refuse)
    g = torch.Generator().manual_seed(0)
    x, r = (torch.randn(4, 6, 32, generator=g, requires_grad=True)
            for _ in range(2))
    w, b = (torch.randn(32, generator=g, requires_grad=True)
            for _ in range(2))
    if fn == "layernorm":
        layernorm.layernorm(x, w, b).sum().backward()
        assert calls == [False]
    else:
        s, y = layernorm.add_layernorm(x, r, w, b)
        (s.sum() + (y * y).sum()).backward()
        assert calls == [True]
    assert x.grad is not None and w.grad is not None and b.grad is not None


@pytest.mark.parametrize("xdt,wdt,bdt", [
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32)])
def test_output_dtypes(xdt, wdt, bdt):
    """dx in x's dtype, dw in w's, db in b's — through the wrapper and
    through LayerNormFn (f32 masters under a bf16 x included)."""
    x, w, _, gy, gs, mean, rstd = _operands(5, 32, 9)
    dx, dw, db = layernorm.layernorm_bwd(
        _t(gy).to(xdt), _t(x).to(xdt), _t(w).to(wdt), _t(mean), _t(rstd),
        _t(gs).to(xdt), wdt, bdt)
    assert (dx.dtype, dw.dtype, db.dtype) == (xdt, wdt, bdt)
    assert dx.shape == (5, 32) and dw.shape == db.shape == (32,)
    xt = _t(x).to(xdt).requires_grad_()
    wt, bt = _t(w).to(wdt).requires_grad_(), _t(w).to(bdt).requires_grad_()
    layernorm.layernorm(xt, wt, bt).float().sum().backward()
    assert (xt.grad.dtype, wt.grad.dtype, bt.grad.dtype) == (xdt, wdt, bdt)


def _bad_operands():
    x, s = torch.zeros(4, 8), torch.zeros(4)
    w = torch.ones(8)
    return {
        "shape": ((torch.zeros(4, 7), x, w, s, s), "does not match"),
        "f64": ((x.double(), x.double(), w, s, s), "f32/bf16/f16"),
        "gy dtype": ((x.half(), x, w, s, s), "f32/bf16/f16"),
        "mean shape": ((x, x, w, torch.zeros(3), s), "mean/rstd"),
        "rstd dtype": ((x, x, w, s, s.double()), "mean/rstd"),
        "n zero": ((torch.zeros(4, 0), torch.zeros(4, 0), torch.ones(0), s,
                    s), r"not in \[1, 16384\]"),
        "n too wide": ((torch.zeros(1, 16385), torch.zeros(1, 16385),
                        torch.ones(16385), torch.zeros(1), torch.zeros(1)),
                       r"not in \[1, 16384\]"),
        "weight": ((x, x, torch.ones(7), s, s), "weight"),
        "gs shape": ((x, x, w, s, s, torch.zeros(4, 9)), "gs"),
        "gs dtype": ((x, x, w, s, s, x.half()), "gs"),
        "dw dtype": ((x, x, w, s, s, None, torch.float64), "dw/db"),
        "cpu": ((x, x, w, s, s), "CUDA device"),
    }


@pytest.mark.parametrize("case", list(_bad_operands()))
def test_cuda_wrapper_refuses_bad_operands(case):
    """Each check raises ValueError with its own message before anything
    is built: on this host (no nvcc) a build would raise RuntimeError."""
    args, match = _bad_operands()[case]
    with pytest.raises(ValueError, match=match):
        layernorm._ln_bwd_cuda(*args)


def test_cpu_calls_count_no_launches():
    before = (layernorm.layernorm_bwd.launches,
              layernorm.layernorm_bwd.launches_gs)
    x, w, _, gy, gs, mean, rstd = _operands(8, 64, 3)
    layernorm.layernorm_bwd(_t(gy), _t(x), _t(w), _t(mean), _t(rstd),
                            _t(gs))
    xt = _t(x).requires_grad_()
    s, y = layernorm.add_layernorm(xt, _t(gy), _t(w), _t(w))
    (s.sum() + layernorm.layernorm(y, _t(w), _t(w)).sum()).backward()
    assert (layernorm.layernorm_bwd.launches,
            layernorm.layernorm_bwd.launches_gs) == before


@pytest.mark.parametrize("ok", [True, False], ids=["passes", "fails"])
def test_require_formats_its_message_only_on_failure(ok):
    """`require` takes a callable message and calls it only when the
    check fails, so a wrapper's checks cost no formatting on the hot
    path."""
    from tiny_deepspeed_tpu_torch.ops.dispatch import require
    calls = []

    def msg():
        calls.append(1)
        return "refused"

    if ok:
        require(True, msg)
    else:
        with pytest.raises(ValueError, match="refused"):
            require(False, msg)
    assert calls == ([] if ok else [1])
