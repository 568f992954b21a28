# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's blockwise quantizer and quantized KV pool against the JAX
package's, on the CPU.

`ops/quant.quantize_blockwise` (whose plain version the card kernel is
held to bit for bit) must give the same codes and scales as JAX's XLA
codec (`parallel/comm.quantize_blockwise`) and its Pallas kernel
(`ops/quant_pallas.pallas_quantize_blockwise`, interpret mode): int8
round-to-nearest, int8 with one numpy dither fed to both, and fp8, at
block 64 (the KV head vector) and 256 (the grad-comm block).  The pool's
quantized writers (`_quant_vectors`, `paged_append`, `paged_scatter`,
`paged_append_span`), the dequantizing `paged_panel` and `kv_bytes` are
held to `serving/pool.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.quant_pallas as JQP
from tiny_deepspeed_tpu.parallel import comm as jcomm
from tiny_deepspeed_tpu.serving import pool as jpool
from tiny_deepspeed_tpu_torch.ops import quant
from tiny_deepspeed_tpu_torch.serving import pool as tpool


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JQP, "_INTERPRET", True)


def _codes(q):
    """Codes as raw bytes, from either side."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy() if q.dtype != torch.int8 \
            else q.numpy().view(np.uint8)
    return np.asarray(q).view(np.uint8)


def _x(block, nb=16, seed=0):
    """Blocks spanning magnitudes 1e-8..1e7, with a zero block and exact
    .5 ties after scaling."""
    rng = np.random.default_rng(seed + block)
    x = rng.standard_normal((nb, block)).astype(np.float32)
    x *= (10.0 ** np.arange(-8, nb - 8, dtype=np.float32))[:, None]
    x[3] = 0.0
    x[5, :4] = [127.0, 0.5, -1.5, 2.5]  # s = 1 + 1e-12: halves stay ties
    x[5, 4:] = 0.25
    return x.reshape(-1)


class TestQuantizeBlockwise:
    @pytest.mark.parametrize("block", [64, 256])
    @pytest.mark.parametrize("mode,dither", [("int8", False), ("int8", True),
                                             ("fp8", False)])
    def test_codes_and_scales_equal_jax(self, mode, dither, block):
        """Bit-equal to the XLA codec (one dither draw fed to both); the
        Pallas kernel (interpret mode) gives the same codes and scales
        within 1 ulp — its division rounds otherwise, and JAX's own test
        (test_grad_comm.py:152-167) pins its scales to the XLA codec's at
        rtol 1e-6."""
        x = _x(block)
        jx = jnp.asarray(x)
        rng = jax.random.PRNGKey(9) if dither else None
        xq, xs = jcomm.quantize_blockwise(jx, mode, block, rng)
        jd = (jax.random.uniform(rng, jx.shape, jnp.float32, -0.5, 0.5)
              if dither else None)
        tq, ts = quant.quantize_blockwise(
            torch.from_numpy(x), mode, block,
            None if jd is None else torch.from_numpy(np.array(jd)))
        assert tq.dtype == quant.QDTYPE[mode]
        assert ts.shape == (x.size // block, 1)
        np.testing.assert_array_equal(_codes(tq), _codes(xq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(xs))
        pq, ps = JQP.pallas_quantize_blockwise(jx, mode, block, jd)
        np.testing.assert_array_equal(_codes(tq), _codes(pq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(ps), rtol=1e-6)

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_dequantize_matches_jax(self, mode):
        x = _x(64)
        tq, ts = quant.quantize_blockwise(torch.from_numpy(x), mode, 64)
        jq, js = jcomm.quantize_blockwise(jnp.asarray(x), mode, 64)
        np.testing.assert_array_equal(
            quant.dequantize_blockwise(tq, ts).numpy(),
            np.asarray(jcomm.dequantize_blockwise(jq, js)))

    def test_bf16_input_equals_its_f32_upcast(self):
        x = torch.from_numpy(_x(64)).bfloat16()
        a = quant.quantize_blockwise(x, "int8", 64)
        b = quant.quantize_blockwise(x.float(), "int8", 64)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_refusals(self):
        with pytest.raises(ValueError, match="int8/fp8"):
            quant.quantize_blockwise(torch.zeros(64), "int4", 64)
        with pytest.raises(ValueError, match="multiple"):
            quant._quantize_triton(torch.zeros(65), "int8", 64)
        with pytest.raises(ValueError, match="dither"):
            quant._quantize_triton(torch.zeros(64), "int8", 64,
                                   torch.zeros(32))
        assert quant.quantize_blockwise.launches == 0


# pool geometry: (NB+1, bt, L, KVH, Dh)
_GEO = dict(n_layer=2, kv_heads=2, head_dim=16, num_blocks=8, block_tokens=4)


def _pools(mode):
    jp = jpool.PagedKVPool(dtype=jnp.float32, quant=mode, **_GEO)
    tp = tpool.PagedKVPool(dtype=torch.float32, quant=mode, device="cpu",
                           **_GEO)
    return jp, tp


def _assert_views_equal(tv, jv):
    np.testing.assert_array_equal(_codes(tv.k), _codes(jv.k))
    np.testing.assert_array_equal(_codes(tv.v), _codes(jv.v))
    if jv.k_scale is None:
        assert tv.k_scale is None
        return
    np.testing.assert_array_equal(tv.k_scale.numpy(), np.asarray(jv.k_scale))
    np.testing.assert_array_equal(tv.v_scale.numpy(), np.asarray(jv.v_scale))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_vectors_match_jax(mode):
    x = np.random.default_rng(1).standard_normal((3, 2, 16)).astype(
        np.float32)
    tq, ts = tpool._quant_vectors(torch.from_numpy(x), mode)
    jq, js = jpool._quant_vectors(jnp.asarray(x), mode)
    assert tq.shape == (3, 2, 16) and ts.shape == (3, 2)
    np.testing.assert_array_equal(_codes(tq), _codes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
class TestQuantizedPool:
    def test_writers_and_panel_match_jax(self, mode):
        rng = np.random.default_rng(7)
        jp, tp = _pools(mode)
        jv, tv = jp.view, tp.view
        assert tpool.quant_mode(tv) == jpool.quant_mode(jv) == mode
        # prefill scatter: a 8-token prompt into blocks [3, 5]
        ks, vs = (rng.standard_normal((2, 1, 2, 8, 16)).astype(np.float32)
                  for _ in range(2))
        ids = np.asarray([3, 5], np.int32)
        jv = jpool.paged_scatter(jv, jnp.asarray(ks), jnp.asarray(vs),
                                 jnp.asarray(ids), 4)
        tpool.paged_scatter(tv, torch.from_numpy(ks), torch.from_numpy(vs),
                            torch.from_numpy(ids), 4)
        _assert_views_equal(tv, jv)
        # one decode append per slot at layer 1 (slot 1 invalid -> scratch)
        tables = np.asarray([[3, 5, 6], [0, 0, 0]], np.int32)
        pos = np.asarray([8, 0], np.int32)
        k, v = (rng.standard_normal((2, 2, 16)).astype(np.float32)
                for _ in range(2))
        jpage = jpool.page_ref(jnp.asarray(tables), jnp.asarray(pos), 4)
        tpage = tpool.page_ref(torch.from_numpy(tables),
                               torch.from_numpy(pos), 4)
        jv = jpool.paged_append(jv, jnp.asarray(k), jnp.asarray(v), 1, jpage)
        tpool.paged_append(tv, torch.from_numpy(k), torch.from_numpy(v), 1,
                           tpage)
        _assert_views_equal(tv, jv)
        # a span commit: slot 0 commits 3 of 4 offsets from position 9,
        # slot 1 commits none (everything lands in scratch)
        sks, svs = (rng.standard_normal((2, 2, 2, 4, 16)).astype(np.float32)
                    for _ in range(2))
        pos0 = np.asarray([9, 0], np.int32)
        count = np.asarray([3, 0], np.int32)
        jv = jpool.paged_append_span(jv, jnp.asarray(sks), jnp.asarray(svs),
                                     jnp.asarray(tables), jnp.asarray(pos0),
                                     jnp.asarray(count), 4)
        tpool.paged_append_span(tv, torch.from_numpy(sks),
                                torch.from_numpy(svs),
                                torch.from_numpy(tables),
                                torch.from_numpy(pos0),
                                torch.from_numpy(count), 4)
        real = [b for b in range(1, 9)]  # scratch holds whichever dup won
        for side in ("k", "v"):
            np.testing.assert_array_equal(
                _codes(getattr(tv, side))[real],
                _codes(getattr(jv, side))[real])
        for layer in range(2):
            tk, tvv = tpool.paged_panel(tv, layer, tpage, torch.float32)
            jk, jvv = jpool.paged_panel(jv, layer, jpage, jnp.float32)
            np.testing.assert_array_equal(tk.numpy()[0], np.asarray(jk)[0])
            np.testing.assert_array_equal(tvv.numpy()[0], np.asarray(jvv)[0])

    def test_kv_bytes_match_jax(self, mode):
        jp, tp = _pools(mode)
        assert tp.kv_bytes() == jp.kv_bytes()
        assert tp.quant == mode
