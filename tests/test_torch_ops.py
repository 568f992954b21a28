# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Kernel-module parity: the PyTorch port against the JAX package's Pallas
kernels, on the CPU.

Each module of the port that replaces a Pallas kernel (layernorm forward,
FA2 causal forward, paged decode attention; the span and quantized
variants and the quantizer have test_torch_spec.py and
test_torch_quant.py) is held here against that
kernel run the way the JAX tests run it on the CPU — Pallas interpret
mode — on the same numpy-seeded inputs, at atol = rtol = 1e-5 in f32
(the two sides differ only in summation order).  On CPU tensors the
port's wrappers take their plain PyTorch version, so this pins the plain
versions the card kernels are checked against (chip_smoke.py,
tests/test_torch_cuda.py).  Also pinned: the CUDA-path operand checks
raise before any build, and no kernel launch is counted on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.flash_fa2 as JFA
import tiny_deepspeed_tpu.ops.layernorm_pallas as JLN
import tiny_deepspeed_tpu.ops.paged_attn_pallas as JPA
from tiny_deepspeed_tpu.serving import pool as jpool
from tiny_deepspeed_tpu_torch.ops import attention, flash_fa2, layernorm
from tiny_deepspeed_tpu_torch.ops import paged_attn
from tiny_deepspeed_tpu_torch.serving import pool as tpool

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JLN, "INTERPRET", True)
    monkeypatch.setattr(JFA, "_INTERPRET", True)
    monkeypatch.setattr(JPA, "INTERPRET", True)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestLayernorm:
    @pytest.mark.parametrize("rows,n", [(8, 64), (24, 96), (16, 768)])
    def test_plain_matches_pallas(self, rows, n):
        rng = np.random.default_rng(rows + n)
        x = _rand(rng, rows, n, scale=3.0) + 0.5
        w, b = _rand(rng, n), _rand(rng, n)
        jy, jm, jr = JLN.ln_fwd_pallas(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b))
        ty, tm, tr = layernorm.layernorm_fwd(_t(x), _t(w), _t(b))
        for j, t in ((jy, ty), (jm, tm), (jr, tr)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)

    def test_leading_dims_and_dtype(self):
        rng = np.random.default_rng(3)
        x = _t(_rand(rng, 2, 5, 32)).to(torch.bfloat16)
        y, mean, rstd = layernorm.layernorm_fwd(
            x, torch.ones(32), torch.zeros(32))
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        assert mean.shape == rstd.shape == (2, 5)
        assert mean.dtype == rstd.dtype == torch.float32


class TestFlashFA2:
    @pytest.mark.parametrize("b,h,kvh,t,blk", [
        (1, 2, 2, 64, 64),      # one block
        (2, 2, 2, 256, 128),    # diagonal straddles two k-blocks
        (1, 4, 2, 128, 128),    # grouped K/V (GQA)
    ])
    def test_plain_matches_pallas(self, b, h, kvh, t, blk):
        rng = np.random.default_rng(t + h)
        q = _rand(rng, b, h, t, 32)
        k, v = _rand(rng, b, kvh, t, 32), _rand(rng, b, kvh, t, 32)
        jo, res = JFA._fa2_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), blk, blk)
        jlse = np.asarray(res[-1]).reshape(b, h, t)
        to, tlse = flash_fa2.fa2_flash_attention_fwd(_t(q), _t(k), _t(v))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tlse.numpy(), jlse, **TOL)

    def test_flash_and_standard_agree_on_cpu(self):
        rng = np.random.default_rng(5)
        q, k, v = (_t(_rand(rng, 1, 2, 48, 32)) for _ in range(3))
        torch.testing.assert_close(attention.flash_attention(q, k, v),
                                   attention.standard_attention(q, k, v))


_TABLES = [[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]]


class TestPagedAttention:
    @pytest.mark.parametrize("hq", [2, 4])
    def test_plain_matches_pallas(self, hq):
        rng = np.random.default_rng(hq)
        shape = (17, 8, 2, 2, 16)  # (NB+1, bt, L, KVH, Dh)
        kp, vp = _rand(rng, *shape), _rand(rng, *shape)
        q = _rand(rng, 3, hq, 1, 16)
        tables = np.asarray(_TABLES, np.int32)
        pos = np.asarray([25, 9, 0], np.int32)  # mid / partial / first
        jview = jpool.KVPoolView(jnp.asarray(kp), jnp.asarray(vp), None,
                                 None)
        jpage = jpool.page_ref(jnp.asarray(tables), jnp.asarray(pos), 8)
        tview = tpool.KVPoolView(_t(kp), _t(vp))
        tpage = tpool.page_ref(_t(tables), _t(pos), 8)
        for layer in range(2):
            ref = JPA.paged_attention(jnp.asarray(q), jview, jpage, layer)
            got = paged_attn.paged_attention(_t(q), tview, tpage, layer)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    def test_span_and_quant_variants_refused(self):
        """The span and int8/fp8 variants are ported (their parity is in
        test_torch_spec.py); what stays refused is a span whose K/V do
        not match q, and a quantized pool without scales on the card."""
        view = tpool.KVPoolView(torch.zeros(2, 8, 1, 1, 16),
                                torch.zeros(2, 8, 1, 1, 16))
        page = tpool.page_ref(torch.zeros(1, 1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 8)
        q = torch.zeros(1, 1, 3, 16)
        bad = torch.zeros(1, 1, 2, 16)
        with pytest.raises(ValueError, match="span"):
            paged_attn.paged_attention(q, view, page, 0, span_kv=(bad, bad))
        qview = view._replace(k=view.k.to(torch.int8),
                              v=view.v.to(torch.int8))
        with pytest.raises(ValueError, match="scales"):
            paged_attn._paged_attention_cuda(q[:, :, :1], qview, page, 0)


class TestCudaPathChecks:
    """The CUDA wrappers validate operands before anything is built, so a
    shape the kernel cannot take raises ValueError — never a fallback."""

    def test_flash_rejects_bad_operands(self):
        q = torch.zeros(1, 3, 16, 64)
        with pytest.raises(ValueError, match="group"):
            flash_fa2._fa2_fwd_cuda(q, torch.zeros(1, 2, 16, 64),
                                    torch.zeros(1, 2, 16, 64))
        with pytest.raises(ValueError, match="head dim"):
            z = torch.zeros(1, 2, 16, 48)
            flash_fa2._fa2_fwd_cuda(z, z, z)
        with pytest.raises(ValueError, match="dtype"):
            z = torch.zeros(1, 2, 16, 64)
            flash_fa2._fa2_fwd_cuda(z, z.double(), z)

    def test_flash_operands_land_on_16_bytes(self):
        """The tensor-core FA2 kernels copy 16-byte chunks: a contiguous
        view whose storage offset breaks the alignment is copied, an
        aligned operand is passed as it is."""
        buf = torch.arange(65, dtype=torch.bfloat16)
        view = buf[1:].view(1, 1, 1, 64)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        got = flash_fa2._aligned(view)
        assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
        ok = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
        assert flash_fa2._aligned(ok) is ok

    def test_paged_rejects_bad_operands(self):
        view = tpool.KVPoolView(torch.zeros(2, 8, 1, 2, 64),
                                torch.zeros(2, 8, 1, 2, 64))
        page = tpool.page_ref(torch.zeros(1, 1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 8)
        with pytest.raises(ValueError, match="one query position"):
            paged_attn._paged_attention_cuda(torch.zeros(1, 2, 3, 64),
                                             view, page, 0)
        with pytest.raises(ValueError, match="layer"):
            paged_attn._paged_attention_cuda(torch.zeros(1, 2, 1, 64),
                                             view, page, 5)
        bf = view._replace(k=view.k.bfloat16(), v=view.v.bfloat16())
        with pytest.raises(ValueError, match="not"):
            paged_attn._paged_attention_cuda(
                torch.zeros(1, 2, 1, 64, dtype=torch.float16), bf, page, 0)

    def test_layernorm_rejects_bad_operands(self):
        with pytest.raises(ValueError, match="weight/bias"):
            layernorm._ln_fwd_triton(torch.zeros(4, 8), torch.ones(7),
                                     torch.zeros(8), 1e-5)

    def test_mixed_devices_refused(self):
        from tiny_deepspeed_tpu_torch.ops.dispatch import on_cuda
        assert not on_cuda(torch.zeros(1), None)

    def test_cpu_calls_count_no_launches(self):
        counters = (layernorm.layernorm_fwd, flash_fa2.fa2_flash_attention_fwd,
                    paged_attn.paged_attention)
        before = [f.launches for f in counters]
        x = torch.zeros(2, 4, 8, 32)
        layernorm.layernorm_fwd(x, torch.ones(32), torch.zeros(32))
        flash_fa2.fa2_flash_attention_fwd(x, x, x)
        assert [f.launches for f in counters] == before
