# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Backward-kernel parity: the port's training ops against the JAX
package's Pallas kernels and vjp rules, on the CPU.

The plain versions of the four backward kernels (`_ln_dx_plain`,
`_ln_dwdb_plain`, `_fa2_dq_plain`, `_fa2_dkv_plain`) are held against the
Pallas kernels they replace, run in interpret mode as the JAX tests run
them, on the same numpy-seeded inputs, at atol = rtol = 1e-5 in f32 (the
two sides differ only in summation order).  The autograd Functions
(`LayerNormFn`, `FA2Fn`) are held against `jax.grad` of the JAX ops and
against finite differences (`torch.autograd.gradcheck`, f64).  On CPU
tensors the wrappers take their plain versions, which is what the card
kernels are checked against (chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.flash_fa2 as JFA
import tiny_deepspeed_tpu.ops.layernorm_pallas as JLN
from tiny_deepspeed_tpu.ops.layernorm import layernorm as jax_layernorm
from tiny_deepspeed_tpu_torch.ops import flash_fa2, layernorm
from tiny_deepspeed_tpu_torch.ops.softmax_xent import softmax_cross_entropy
from tiny_deepspeed_tpu.ops.softmax_xent import \
    softmax_cross_entropy as jax_xent

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JLN, "INTERPRET", True)
    monkeypatch.setattr(JFA, "_INTERPRET", True)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestLayernormBackward:
    @pytest.mark.parametrize("rows,n", [(8, 64), (24, 96), (512, 768)])
    def test_plain_matches_pallas(self, rows, n):
        rng = np.random.default_rng(rows + n)
        x = _rand(rng, rows, n, scale=3.0) + 0.5
        w, gy = _rand(rng, n), _rand(rng, rows, n)
        _, mean, rstd = JLN.ln_fwd_pallas(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(w))
        jdx = JLN.ln_dx_pallas(jnp.asarray(gy), jnp.asarray(x),
                               jnp.asarray(w), mean, rstd)
        jdw, jdb = JLN.ln_dwdb_pallas(jnp.asarray(gy), jnp.asarray(x),
                                      mean, rstd)
        tm, tr = _t(mean), _t(rstd)
        tdx = layernorm.layernorm_dx(_t(gy), _t(x), _t(w), tm, tr)
        tdw, tdb = layernorm.layernorm_dwdb(_t(gy), _t(x), tm, tr)
        np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
        # sums over `rows` terms of size ~3: the tolerance scales with them
        for got, ref in ((tdw, jdw), (tdb, jdb)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-5 * rows ** 0.5, rtol=1e-5)

    def test_dtypes_and_leading_dims(self):
        rng = np.random.default_rng(3)
        x = _t(_rand(rng, 2, 5, 32)).to(torch.bfloat16)
        gy = _t(_rand(rng, 2, 5, 32)).to(torch.bfloat16)
        w = torch.ones(32)
        _, mean, rstd = layernorm.layernorm_fwd(x, w, torch.zeros(32))
        dx = layernorm.layernorm_dx(gy, x, w, mean, rstd)
        dw, db = layernorm.layernorm_dwdb(gy, x, mean, rstd)
        assert dx.dtype == dw.dtype == db.dtype == torch.bfloat16
        assert dx.shape == x.shape and dw.shape == db.shape == (32,)

    @pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
    def test_function_grads_match_jax(self, xdt):
        """LayerNormFn vs jax.grad of the JAX custom_vjp layernorm: f32
        masters w/b with x in the compute dtype, dw/db routed through
        x's dtype into w's, as `_layernorm_bwd_rule` does."""
        rng = np.random.default_rng(11)
        x, gy = _rand(rng, 4, 6, 64, scale=2.0), _rand(rng, 4, 6, 64)
        w, b = _rand(rng, 64), _rand(rng, 64)
        jdt = jnp.float32 if xdt == torch.float32 else jnp.bfloat16

        def jloss(x_, w_, b_):
            y = jax_layernorm(x_.astype(jdt), w_, b_)
            return jnp.sum(y.astype(jnp.float32) * jnp.asarray(gy))

        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, b))
        y = layernorm.layernorm(tx.to(xdt), tw, tb)
        (y.float() * _t(gy)).sum().backward()
        assert tw.grad.dtype == tb.grad.dtype == torch.float32
        # bf16 included: both sides round at the same places
        for got, ref in zip((tx.grad, tw.grad, tb.grad), jg):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(ref, np.float32), **TOL)

    def test_gradcheck_f64(self):
        g = torch.Generator().manual_seed(0)
        x = torch.randn(3, 5, 8, generator=g, dtype=torch.float64,
                        requires_grad=True)
        w = torch.randn(8, generator=g, dtype=torch.float64,
                        requires_grad=True)
        b = torch.randn(8, generator=g, dtype=torch.float64,
                        requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda *a: layernorm.LayerNormFn.apply(*a, 1e-5), (x, w, b))


def _jax_flat(a):
    b, h, t, d = a.shape
    return jnp.asarray(a.reshape(b * h, t, d))


class TestFlashBackward:
    @pytest.mark.parametrize("b,h,kvh,t,blk", [
        (1, 2, 2, 64, 64),      # one block
        (2, 2, 2, 256, 128),    # diagonal straddles two blocks
        (1, 4, 2, 256, 128),    # grouped K/V (GQA), several blocks
    ])
    def test_plain_matches_pallas(self, b, h, kvh, t, blk):
        rng = np.random.default_rng(t + h + kvh)
        d = 32
        q, do = _rand(rng, b, h, t, d), _rand(rng, b, h, t, d)
        k, v = _rand(rng, b, kvh, t, d), _rand(rng, b, kvh, t, d)
        scale = 1.0 / np.sqrt(d)
        group = h // kvh
        jq, jk, jv, jdo = (_jax_flat(a) for a in (q, k, v, do))
        jo, jlse = JFA._fwd(jq, jk, jv, scale=scale, bq=blk, bk=blk,
                            group=group)
        jdi = jnp.sum(jdo * jo, axis=-1)[:, None, :]
        jdq = JFA._dq_call(jq, jk, jv, jdo, jlse, jdi, scale=scale, bq=blk,
                           bk=blk, group=group)
        jdk, jdv = JFA._dkv_call(jq, jk, jv, jdo, jlse, jdi, scale=scale,
                                 bq=blk, bk=blk, group=group)
        lse = _t(np.asarray(jlse).reshape(b, h, t))
        di = _t(np.asarray(jdi).reshape(b, h, t))
        tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
        tdq = flash_fa2.fa2_flash_attention_dq(tq, tk, tv, tdo, lse, di)
        tdk, tdv = flash_fa2.fa2_flash_attention_dkv(tq, tk, tv, tdo, lse,
                                                     di)
        assert tdk.shape == tdv.shape == (b, kvh, t, d)
        for got, ref in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(ref).reshape(got.shape), **TOL)

    @pytest.mark.parametrize("kvh", [2, 1])
    def test_function_grads_match_jax(self, kvh):
        """FA2Fn vs jax.grad of the JAX custom_vjp `fa2_flash_attention`
        (Pallas forward and backward in interpret mode)."""
        rng = np.random.default_rng(kvh)
        b, h, t, d = 2, 2, 128, 32
        q, r = _rand(rng, b, h, t, d), _rand(rng, b, h, t, d)
        k, v = _rand(rng, b, kvh, t, d), _rand(rng, b, kvh, t, d)

        def jloss(q_, k_, v_):
            o = JFA.fa2_flash_attention(q_, k_, v_, 64, 64)
            return jnp.sum(o * jnp.asarray(r))

        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        (flash_fa2.FA2Fn.apply(tq, tk, tv) * _t(r)).sum().backward()
        for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    @pytest.mark.parametrize("kvh", [2, 1])
    def test_gradcheck_f64(self, kvh):
        g = torch.Generator().manual_seed(kvh)
        q = torch.randn(1, 2, 6, 4, generator=g, dtype=torch.float64,
                        requires_grad=True)
        k = torch.randn(1, kvh, 6, 4, generator=g, dtype=torch.float64,
                        requires_grad=True)
        v = torch.randn(1, kvh, 6, 4, generator=g, dtype=torch.float64,
                        requires_grad=True)
        assert torch.autograd.gradcheck(flash_fa2.FA2Fn.apply, (q, k, v))


class TestSoftmaxXent:
    def test_matches_jax(self):
        rng = np.random.default_rng(0)
        logits = _rand(rng, 2, 7, 50, scale=3.0)
        tgt = rng.integers(0, 50, (2, 7))
        ref = jax_xent(jnp.asarray(logits), jnp.asarray(tgt))
        got = softmax_cross_entropy(_t(logits), _t(tgt))
        np.testing.assert_allclose(float(got), float(ref), **TOL)
        assert got.dtype == torch.float32


class TestCudaPathChecks:
    """The backward wrappers validate operands before anything is built:
    a shape the kernel cannot take raises ValueError, never a fallback."""

    def test_layernorm_backward_rejects_bad_operands(self):
        x, s = torch.zeros(4, 8), torch.zeros(4)
        with pytest.raises(ValueError, match="do not match"):
            layernorm._ln_dx_triton(torch.zeros(4, 7), x, torch.ones(8), s,
                                    s)
        with pytest.raises(ValueError, match="mean/rstd"):
            layernorm._ln_dwdb_triton(x, x, torch.zeros(3), s)
        with pytest.raises(ValueError, match="f32/bf16/f16"):
            layernorm._ln_dwdb_triton(x.double(), x.double(), s, s)

    def test_flash_backward_rejects_bad_operands(self):
        q = torch.zeros(1, 2, 16, 64)
        st = torch.zeros(1, 2, 16)
        with pytest.raises(ValueError, match="lse"):
            flash_fa2._fa2_dq_cuda(q, q, q, q, torch.zeros(1, 2, 15), st)
        with pytest.raises(ValueError, match="do"):
            flash_fa2._fa2_dkv_cuda(q, q, q, q.half(), st, st)
        with pytest.raises(ValueError, match="group"):
            k = torch.zeros(1, 3, 16, 64)
            flash_fa2._fa2_dkv_cuda(q, k, k, q, st, st)

    def test_cpu_calls_count_no_launches(self):
        counters = (layernorm.layernorm_dx, layernorm.layernorm_dwdb,
                    flash_fa2.fa2_flash_attention_dq,
                    flash_fa2.fa2_flash_attention_dkv)
        before = [f.launches for f in counters]
        x = torch.randn(1, 2, 8, 32, requires_grad=True)
        w = torch.ones(32, requires_grad=True)
        y = layernorm.layernorm(flash_fa2.FA2Fn.apply(x, x, x), w,
                                torch.zeros(32, requires_grad=True))
        y.sum().backward()
        assert [f.launches for f in counters] == before
