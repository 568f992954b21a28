# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's hand-written kernels on the card, against their plain
versions (marker `cuda`; skipped without a CUDA device).

    python -m pytest tests/test_torch_cuda.py -q

Covers what the serving and training paths do not reach at gpt2-124m
shapes: a ragged T, row count, token count, vocab or leaf size, grouped
K/V, f32 and f16 operands, head dim 32, block sizes other than 16, the
fused xent kernels at D = 64 and 1600 and on a transposed (`wte.t()`)
weight; the paged attention's int8/fp8 decode and span-verify variants
at ragged spans (K1 not a multiple of 16, pos0 = 0 and on a block
boundary, grouped heads) and the blockwise quantizer (bit-identical
codes and scales, bf16 and f32 input, with and without dither, blocks
64, 256 and 100); bitwise repeatability of the backward kernels and of
the fused xent and AdamW kernels; refusal of operands a kernel cannot
take; tiny-preset engines (plain, speculative, prefix cache, int8 pool)
whose greedy tokens on the card match the CPU port's, and tiny-preset
training steps whose gradients on the card match the CPU port's, with
the default and the fused heads.  Slice 5: the unmasked FA2 chunk
kernels at ragged Tl (64, 200, 256, 1000), MHA and grouped K/V, f32 and
bf16, and the causal chunk entry bit for bit the causal kernel; the f32
fused xent kernels against an f64 evaluation; ring attention over four
lockstep threads on the card against the CPU port's; a distributed
engine on the card refusing a gloo process group.  Slice 6: the
heads-last FA2 kernels (#7, #8) bit for bit #4-#6 on transposed copies
and within tolerance of their plain versions, grouped K/V refused.
Slice 7 (the tensor-core FA2 forward and dk/dv for bf16/f16): T = 2048
and 4096, T not a multiple of the 64-row tile (1, 33, 100, 130, 200,
1000), grouped K/V at head dim 32, scores of magnitude ~30, and two
calls giving the same bits.  Slice 9 (the fused head's forward and dx on
the tensor cores for bf16/f16): S around the 64-token tile (63, 64, 65,
129), D past one slice (832, 896), V = 50257 at S = 129, and the forward
and dx bit for bit on a repeat.  Slice 10 (paged attention's split walk,
the tensor-core span kernel): W = 256 with positions up to 4095, pos 0,
live ranges ending on a split boundary, grouped heads 4/2 and 2/1, K1
in {5, 16, 17, 64, 256} (16 and 17 straddle the few-rows / many-rows
switch), bit-identical repeats of decode and span over bf16 and int8
pools, and profiled calls naming the one kernel each call launches.
Slice 11 (fewer launches on the serving tick): the KV-pool write
(`serving/pool.kv_write`, csrc/kv_write.cu) bit for bit the unfused
writers (quantizer + index writes) at the decode, span-commit and
prefill shapes, over f32, bf16, f16, int8 and e4m3 pools, head dims 32,
64 and 128, with one launch a call; the fused residual add + LayerNorm
(`ops/layernorm.add_layernorm`) bit for bit `x + r` then the forward
kernel — s, y, mean, rstd and every gradient — at 8, 40, 512 and 8192
rows of 768 in bf16 and f32.  Slice 12 (LayerNorm's backward in one
pass, `ops/layernorm.layernorm_bwd`, csrc/ln_bwd.cu; `-k ln_bwd`):
against `_ln_bwd_plain` at N in {64, 96, 100, 768, 1001, 1600, 4096,
16384} (100 and 1001 take the one-element chunks, 4096 and 16384 the
wide kernel), 1, 7 and 8192 rows, f32 / bf16 / f16, with and without
gs; the gs variant's dx bit for bit `gs + dx`, two calls bit for bit,
one launch a call; strided and misaligned rows, mixed weight dtypes,
and a refused operand.  Slice 13 (LayerNorm's forward and its
residual-add variant behind one C entry, csrc/ln_fwd.cu; `-k ln_fwd`):
against `_ln_fwd_plain` / `_add_ln_fwd_plain` at 8, 40, 512 and 8192
rows of 768, 8192 of 1600, N = 16384 (the CTA kernels), unaligned N (7,
770) and 0 rows, in f32 / bf16 / f16 with mixed weight dtypes; the add
variant bit for bit `x + r` then the forward; one launch a call; two
calls bit for bit; bit for bit the Triton pair it replaced; strided and
misaligned rows; refused operands.  Slice 14 (the decode append inside
the decode launch, `paged_attention(append_kv=)`; the writer with a lane
group a head vector, fed per layer; `-k "append or kv_write or
scatter"`): the fused decode bit for bit `paged_append` then the decode
kernel over bf16, f16, f32 (and f32 q over bf16) and int8 / e4m3 pools,
Dh 32, 64 and 128, grouped heads, offsets 0 and bt - 1, the table's last
position, the split count forced to 1-8; refused operands; the writer
bit for bit the v1 kernel (`kv_write_v1`) at the three writers' shapes,
and from misaligned sources; the prefill from per-layer views equal to
the stacked call, in one launch per layer group.  Slice 15 (the Llama
family; `-k "rms or llama or g3"`): RMSNorm's forward, its residual-add
variant and its backward (`ops/rmsnorm.py`, the `rms_fwd` / `rms_bwd`
entries of csrc/ln_fwd.cu / csrc/ln_bwd.cu) against their plain
versions at 8, 512 and 8192 rows of 768, 8192 of 2048 (bf16), 768 in f32
and f16, the ragged widths 64, 48 and 2048 at odd row counts, with and
without gs: the add's s bit for bit `x + r`, one launch a call, two
calls bit for bit; grouped K/V at llama-160m's group 3 and llama-1b's
group 4 — FA2 forward and backward at (8, 12, 4, 1024, 64), paged decode,
decode with its append and span (K1 5 and 256) at (Hq, KVH) = (12, 4)
and (32, 8), Dh 64, bt 16, over bf16 and int8 pools; tiny Llama
training gradients and greedy tokens (plain, speculative, prefix cache,
int8 pool) on the card against the CPU port's.  Slice 16 (the MoE
family; `-k moe`): one block at moe-8x124m's widths (D 768, 8 experts,
F 3072, 512 tokens, bf16), forward and backward on the card against the
CPU port's, for both dispatches, and remat on and off bit for bit.
"""

import math

import pytest
import torch

from tiny_deepspeed_tpu_torch.ops import (_build, flash_fa2, fused_xent,
                                          layernorm, paged_attn, quant)
from tiny_deepspeed_tpu_torch.optim import adamw_fused
from tiny_deepspeed_tpu_torch.serving import pool as pool_mod

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float16: dict(atol=2e-3, rtol=2e-3)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only there)")


def _g(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,n", [(1, 64), (37, 768), (5, 1000)])
def test_layernorm_kernel(dtype, rows, n):
    g = _g(rows)
    x = (torch.randn(3, rows, n, generator=g, device="cuda") * 2).to(dtype)
    w = torch.randn(n, generator=g, device="cuda").to(dtype)
    b = torch.randn(n, generator=g, device="cuda").to(dtype)
    before = layernorm.layernorm_fwd.launches
    y, mean, rstd = layernorm.layernorm_fwd(x, w, b)
    torch.cuda.synchronize()
    assert layernorm.layernorm_fwd.launches == before + 1
    py, pm, pr = layernorm._ln_fwd_plain(x, w, b)
    torch.testing.assert_close(y.float(), py.float(), **TOL[dtype])
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(rstd, pr, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,kvh,t,d", [
    (1, 12, 12, 1024, 64), (2, 4, 2, 100, 64), (1, 2, 1, 33, 32),
    (3, 2, 2, 1, 64), (1, 2, 2, 2048, 64), (1, 2, 1, 4096, 64),
    (2, 4, 2, 130, 64), (1, 6, 2, 200, 32), (8, 12, 4, 1024, 64)])
def test_flash_kernel(dtype, b, h, kvh, t, d):
    g = _g(t + h)
    q = torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    before = flash_fa2.fa2_flash_attention_fwd.launches
    o, lse = flash_fa2.fa2_flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash_fa2.fa2_flash_attention_fwd.launches == before + 1
    po, plse = flash_fa2._fa2_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), po.float(), **TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)


def _decode_case(case, bt):
    """(W, positions) of a decode test: "short" stays within one split;
    "long" (W >= 256, at least 4096 positions) spans many — pos 0, a
    live range ending exactly on a split boundary (512 and 1024 keys at
    eight splits of 64-key tiles), one key into the second tile, and pos
    4095."""
    if case == "short":
        w = 6
        return w, [0, bt - 1, bt, 3 * bt + 2, w * bt - 1]
    return max(256, 4096 // bt), [0, 4095, 511, 1023, 64]


@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("qdt,kdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("hq,kvh,d,bt", [(12, 12, 64, 16), (4, 2, 32, 8),
                                         (2, 1, 128, 32), (4, 2, 64, 16),
                                         (12, 4, 64, 16), (32, 8, 64, 16)])
def test_paged_kernel(qdt, kdt, hq, kvh, d, bt, case):
    s, nl = 5, 3
    w, pos = _decode_case(case, bt)
    g = _g(hq * d + bt)
    shape = (s * w + 1, bt, nl, kvh, d)
    view = pool_mod.KVPoolView(
        torch.randn(shape, generator=g, device="cuda").to(kdt),
        torch.randn(shape, generator=g, device="cuda").to(kdt))
    tables = (torch.randperm(s * w, generator=g, device="cuda") + 1
              ).reshape(s, w).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    page = pool_mod.page_ref(tables, pos, bt)
    q = torch.randn(s, hq, 1, d, generator=g, device="cuda").to(qdt)
    for layer in range(nl):
        o = paged_attn.paged_attention(q, view, page, layer)
        torch.cuda.synchronize()
        po = paged_attn._paged_attention_plain(q, view, page, layer)
        assert o.dtype == qdt
        torch.testing.assert_close(o.float(), po.float(),
                                   **TOL[kdt if kdt != torch.float32
                                         else qdt])


def _ln_bwd_inputs(dtype, rows, n, seed):
    g = _g(seed)
    x = (torch.randn(rows, n, generator=g, device="cuda") * 2 + 0.3
         ).to(dtype)
    w = torch.randn(n, generator=g, device="cuda").to(dtype)
    gy = torch.randn(rows, n, generator=g, device="cuda").to(dtype)
    _, mean, rstd = layernorm._ln_fwd_plain(x, w, w)
    return gy, x, w, mean, rstd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,n", [(1, 64), (37, 768), (300, 1600),
                                    (8192, 768)])
def test_layernorm_backward_kernels(dtype, rows, n):
    gy, x, w, mean, rstd = _ln_bwd_inputs(dtype, rows, n, rows + n)
    before = (layernorm.layernorm_dx.launches,
              layernorm.layernorm_dwdb.launches)
    dx = layernorm.layernorm_dx(gy, x, w, mean, rstd)
    dw, db = layernorm.layernorm_dwdb(gy, x, mean, rstd)
    torch.cuda.synchronize()
    assert (layernorm.layernorm_dx.launches,
            layernorm.layernorm_dwdb.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert dx.dtype == dw.dtype == db.dtype == dtype
    torch.testing.assert_close(
        dx.float(), layernorm._ln_dx_plain(gy, x, w, mean, rstd).float(),
        **TOL[dtype])
    pdw, pdb = layernorm._ln_dwdb_plain(gy, x, mean, rstd)
    # sums over up to 8192 rows: the two reductions differ in order only,
    # the tolerance scales with the sum's magnitude
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in ((dw, pdw), (db, pdb)):
        scale = float(ref.float().abs().max()) + 1.0
        assert float((got.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,kvh,t,d", [
    (1, 2, 2, 64, 64), (2, 4, 2, 100, 64), (1, 2, 1, 33, 32),
    (3, 2, 2, 1, 64), (1, 12, 12, 1000, 64), (1, 2, 2, 2048, 64),
    (1, 2, 1, 4096, 64), (2, 4, 2, 130, 64), (1, 6, 2, 200, 32),
    # the tensor-core kernels' 64-row tiles: just short of, at and just
    # past one and two tiles; a query-head group of 4
    (2, 2, 2, 63, 64), (1, 2, 2, 64, 64), (2, 2, 1, 65, 64),
    (1, 2, 2, 127, 32), (1, 8, 2, 300, 64),
    # llama-160m: 12 query heads over 4 kv heads, Dh 64, T 1024
    (8, 12, 4, 1024, 64)])
def test_flash_backward_kernels(dtype, b, h, kvh, t, d):
    g = _g(7 * t + h)
    q = torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
    o, lse = flash_fa2._fa2_fwd_plain(q, k, v)
    di = (do.float() * o.float()).sum(-1)
    before = (flash_fa2.fa2_flash_attention_dq.launches,
              flash_fa2.fa2_flash_attention_dkv.launches)
    dq = flash_fa2.fa2_flash_attention_dq(q, k, v, do, lse, di)
    dk, dv = flash_fa2.fa2_flash_attention_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    assert (flash_fa2.fa2_flash_attention_dq.launches,
            flash_fa2.fa2_flash_attention_dkv.launches) == (before[0] + 1,
                                                            before[1] + 1)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    refs = (flash_fa2._fa2_dq_plain(q, k, v, do, lse, di),
            *flash_fa2._fa2_dkv_plain(q, k, v, do, lse, di))
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == dtype
        # f32 accumulations over up to T keys in another order: the
        # tolerance scales with the gradient's magnitude (at T=1 the
        # gradients are rounding noise around 0: an absolute floor)
        scale = float(ref.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert float((got.float() - ref.float()).abs().max()) <= \
            tol * scale + 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)], ids=["mha", "gqa2"])
@pytest.mark.parametrize("t", [64, 200, 256, 1000])
def test_flash_chunk_kernels(dtype, h, kvh, t):
    """The unmasked chunk entries (ring attention's off-diagonal chunks)
    against their plain versions: forward, dq and dk/dv from a global lse
    and di, counted apart from the causal kernels."""
    b, d = 2, 64
    g = _g(11 * t + kvh)
    q = torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
    causal = (flash_fa2.fa2_flash_attention_fwd.launches,
              flash_fa2.fa2_flash_attention_dq.launches,
              flash_fa2.fa2_flash_attention_dkv.launches)
    chunk = (flash_fa2.fa2_chunk_fwd.launches,
             flash_fa2.fa2_chunk_dq.launches,
             flash_fa2.fa2_chunk_dkv.launches)
    o, lse = flash_fa2.fa2_chunk_fwd(q, k, v, causal=False)
    po, plse = flash_fa2._fa2_fwd_plain(q, k, v, causal=False)
    # a global lse: this chunk's merged with another's, as the ring does
    lse_g = torch.logaddexp(plse, plse - 0.5)
    di = (do.float() * po.float()).sum(-1)
    dq = flash_fa2.fa2_chunk_dq(q, k, v, do, lse_g, di, causal=False)
    dk, dv = flash_fa2.fa2_chunk_dkv(q, k, v, do, lse_g, di, causal=False)
    torch.cuda.synchronize()
    assert (flash_fa2.fa2_chunk_fwd.launches, flash_fa2.fa2_chunk_dq.launches,
            flash_fa2.fa2_chunk_dkv.launches) == tuple(n + 1 for n in chunk)
    assert (flash_fa2.fa2_flash_attention_fwd.launches,
            flash_fa2.fa2_flash_attention_dq.launches,
            flash_fa2.fa2_flash_attention_dkv.launches) == causal
    torch.testing.assert_close(o.float(), po.float(), **TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)
    refs = (flash_fa2._fa2_dq_plain(q, k, v, do, lse_g, di, causal=False),
            *flash_fa2._fa2_dkv_plain(q, k, v, do, lse_g, di, causal=False))
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        scale = float(ref.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert float((got.float() - ref.float()).abs().max()) <= \
            tol * scale + 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "unmasked"])
@pytest.mark.parametrize("h,kvh,t,d", [(4, 4, 130, 64), (4, 2, 1000, 32)])
def test_flash_kernels_large_scores(dtype, causal, h, kvh, t, d):
    """Scores of magnitude ~30 (q, k ~ N(0, 30): q.k / sqrt(Dh) has
    standard deviation 30), so the running row max moves by far more than
    exp's range from one key tile to the next and the online softmax's
    rescale decides the result: forward and dk/dv against their plain
    versions at the usual tolerances."""
    b = 2
    g = _g(5 * t + kvh)
    amp = math.sqrt(30.0)
    q = (torch.randn(b, h, t, d, generator=g, device="cuda") * amp).to(dtype)
    k = (torch.randn(b, kvh, t, d, generator=g, device="cuda") * amp
         ).to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
    o, lse = flash_fa2.fa2_chunk_fwd(q, k, v, causal=causal)
    po, plse = flash_fa2._fa2_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert float(plse.max() - plse.min()) > 30.0  # the scores are large
    torch.testing.assert_close(o.float(), po.float(), **TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)
    di = (do.float() * po.float()).sum(-1)
    dk, dv = flash_fa2.fa2_chunk_dkv(q, k, v, do, plse, di, causal=causal)
    refs = flash_fa2._fa2_dkv_plain(q, k, v, do, plse, di, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in zip((dk, dv), refs):
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= \
            tol * scale + 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "unmasked"])
def test_flash_kernels_bitwise_repeatable(dtype, causal):
    """Two calls on the same inputs give the same bits: the forward (o
    and lse) and dk/dv, grouped K/V at a ragged T (no atomics; each CTA
    accumulates in a fixed order)."""
    g = _g(17)
    q, do = (torch.randn(2, 4, 1000, 64, generator=g, device="cuda"
                         ).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, 2, 1000, 64, generator=g, device="cuda"
                        ).to(dtype) for _ in range(2))
    first = flash_fa2.fa2_chunk_fwd(q, k, v, causal=causal)
    second = flash_fa2.fa2_chunk_fwd(q, k, v, causal=causal)
    di = (do.float() * first[0].float()).sum(-1)
    first += flash_fa2.fa2_chunk_dkv(q, k, v, do, first[1], di,
                                     causal=causal)
    second += flash_fa2.fa2_chunk_dkv(q, k, v, do, first[1], di,
                                      causal=causal)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernels_take_misaligned_views(dtype):
    """Operands that are contiguous views 2 bytes off a 16-byte boundary
    (a storage offset of one element) give the bits of aligned copies:
    forward, dq and dk/dv."""
    g = _g(23)
    shape = (2, 4, 200, 64)
    n = math.prod(shape)
    q, k, v, do = (torch.randn(n + 1, generator=g, device="cuda").to(dtype)
                   [1:].view(shape) for _ in range(4))
    assert all(x.data_ptr() % 16 for x in (q, k, v, do))
    ref = [x.clone() for x in (q, k, v, do)]

    def run(q, k, v, do):
        o, lse = flash_fa2.fa2_flash_attention_fwd(q, k, v)
        di = (do.float() * o.float()).sum(-1)
        return (o, lse, flash_fa2.fa2_flash_attention_dq(q, k, v, do, lse, di),
                *flash_fa2.fa2_flash_attention_dkv(q, k, v, do, lse, di))

    got, want = run(q, k, v, do), run(*ref)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_chunk_causal_is_the_causal_kernel():
    """The chunk entries with causal=True launch the causal kernels: bit
    for bit the causal entries' results, counted with them."""
    g = _g(3)
    q, k, v, do = (torch.randn(2, 4, 300, 64, generator=g, device="cuda"
                               ).bfloat16() for _ in range(4))
    o, lse = flash_fa2.fa2_flash_attention_fwd(q, k, v)
    di = (do.float() * o.float()).sum(-1)
    ref = (o, lse, flash_fa2.fa2_flash_attention_dq(q, k, v, do, lse, di),
           *flash_fa2.fa2_flash_attention_dkv(q, k, v, do, lse, di))
    before = (flash_fa2.fa2_flash_attention_fwd.launches,
              flash_fa2.fa2_chunk_fwd.launches)
    got = (*flash_fa2.fa2_chunk_fwd(q, k, v, causal=True),
           flash_fa2.fa2_chunk_dq(q, k, v, do, lse, di, causal=True),
           *flash_fa2.fa2_chunk_dkv(q, k, v, do, lse, di, causal=True))
    torch.cuda.synchronize()
    assert (flash_fa2.fa2_flash_attention_fwd.launches,
            flash_fa2.fa2_chunk_fwd.launches) == (before[0] + 1, before[1])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,t,d", [(1, 2, 64, 64), (2, 12, 1000, 64),
                                     (2, 4, 130, 32), (1, 4, 65, 64)])
def test_flash_bthd_kernels(dtype, b, h, t, d):
    """The heads-last kernels (#7 fwd, #8 dq and dk/dv): bit for bit the
    (B, H, T, Dh) kernels' results on transposed contiguous copies (the
    JAX package's contract), within tolerance of the plain versions, and
    counted apart from #4-#6; FA2BthdFn's gradients likewise FA2Fn's."""
    g = _g(t + h)
    q, k, v, do = (torch.randn(b, t, h, d, generator=g, device="cuda"
                               ).to(dtype) for _ in range(4))
    tr = [x.transpose(1, 2).contiguous() for x in (q, k, v, do)]
    before = {f: getattr(flash_fa2, f).launches for f in (
        "fa2_flash_attention_fwd", "fa2_flash_attention_bthd_fwd",
        "fa2_flash_attention_bthd_dq", "fa2_flash_attention_bthd_dkv")}
    o, lse = flash_fa2.fa2_flash_attention_bthd_fwd(q, k, v)
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_fa2.fa2_flash_attention_bthd_dq(q, k, v, do, lse, di)
    dk, dv = flash_fa2.fa2_flash_attention_bthd_dkv(q, k, v, do, lse, di)
    after = {f: getattr(flash_fa2, f).launches for f in before}
    assert {f: after[f] - before[f] for f in before} == {
        "fa2_flash_attention_fwd": 0, "fa2_flash_attention_bthd_fwd": 1,
        "fa2_flash_attention_bthd_dq": 1, "fa2_flash_attention_bthd_dkv": 1}
    ro, rlse = flash_fa2.fa2_flash_attention_fwd(*tr[:3])
    rdq = flash_fa2.fa2_flash_attention_dq(*tr, rlse, di)
    rdk, rdv = flash_fa2.fa2_flash_attention_dkv(*tr, rlse, di)
    torch.cuda.synchronize()
    assert torch.equal(lse, rlse)
    for got, ref in zip((o, dq, dk, dv), (ro, rdq, rdk, rdv)):
        assert torch.equal(got, ref.transpose(1, 2))
    po, plse = flash_fa2._fa2_bthd_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), po.float(), **TOL[dtype])
    refs = (flash_fa2._fa2_bthd_dq_plain(q, k, v, do, lse, di),
            *flash_fa2._fa2_bthd_dkv_plain(q, k, v, do, lse, di))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref in zip((dq, dk, dv), refs):
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= \
            tol * scale + 1e-5
    args = [x.clone().requires_grad_() for x in (q, k, v)]
    targs = [x.clone().requires_grad_() for x in tr[:3]]
    grads = torch.autograd.grad(flash_fa2.FA2BthdFn.apply(*args), args, do)
    tgrads = torch.autograd.grad(flash_fa2.FA2Fn.apply(*targs), targs, tr[3])
    for a, ref in zip(grads, tgrads):
        assert torch.equal(a, ref.transpose(1, 2))


def test_flash_bthd_refuses_grouped_kv():
    q = torch.zeros(1, 16, 4, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="MHA"):
        flash_fa2.fa2_flash_attention_bthd_fwd(q, kv, kv)


def _ln_bwd_rel(got, ref):
    """max abs err over max |ref|, per output."""
    return [float((a.float() - r.float()).abs().max())
            / max(float(r.float().abs().max()), 1e-30)
            for a, r in zip(got, ref)]


LN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.mark.parametrize("add", [False, True], ids=["nogs", "gs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows", [1, 7, 8192])
@pytest.mark.parametrize("n", [64, 96, 100, 768, 1001, 1600, 4096, 16384])
def test_ln_bwd_kernel(n, rows, dtype, add):
    """layernorm_bwd against _ln_bwd_plain (per output, max abs err <=
    tol x max |plain|), one launch, repeatable, and with gs the dx of
    `gs +` the call without it, bit for bit."""
    gy, x, w, mean, rstd = _ln_bwd_inputs(dtype, rows, n, rows + n)
    gs = torch.randn(rows, n, generator=_g(n), device="cuda").to(dtype)
    g = gs if add else None
    before = layernorm.layernorm_bwd.launches
    got = layernorm.layernorm_bwd(gy, x, w, mean, rstd, g)
    torch.cuda.synchronize()
    assert layernorm.layernorm_bwd.launches == before + 1
    ref = layernorm._ln_bwd_plain(gy, x, w, mean, rstd, g)
    assert all(a.dtype == r.dtype and a.shape == r.shape
               for a, r in zip(got, ref))
    assert max(_ln_bwd_rel(got, ref)) <= LN_BWD_TOL[dtype]
    again = layernorm.layernorm_bwd(gy, x, w, mean, rstd, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if add:
        nogs = layernorm.layernorm_bwd(gy, x, w, mean, rstd)
        assert torch.equal(got[0], gs + nogs[0])
        assert torch.equal(got[1], nogs[1]) and torch.equal(got[2], nogs[2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_bwd_strided_misaligned_and_mixed_dtypes(dtype):
    """gy as a column slice of a wider buffer (a row stride, no copy), x
    and gs one element off a 16-byte boundary (the one-element chunks),
    an f32 weight under a bf16 x, dw in f32 and db in f16."""
    rows, n = 300, 768
    gy, x, w, mean, rstd = _ln_bwd_inputs(dtype, rows, n, 3)
    wide = torch.zeros(rows, n + 64, device="cuda", dtype=dtype)
    wide[:, :n] = gy
    flat = torch.zeros(2 * rows * n + 1, device="cuda", dtype=dtype)
    xo = flat[1:rows * n + 1].view(rows, n)
    xo.copy_(x)
    gso = flat[rows * n + 1:].view(rows, n)
    gso.copy_(torch.randn(rows, n, generator=_g(4), device="cuda"))
    wf = w.float()
    got = layernorm.layernorm_bwd(wide[:, :n], xo, wf, mean, rstd, gso,
                                  torch.float32, torch.float16)
    ref = layernorm._ln_bwd_plain(gy, x, wf, mean, rstd, gso.clone(),
                                  torch.float32, torch.float16)
    torch.cuda.synchronize()
    assert [a.dtype for a in got] == [dtype, torch.float32, torch.float16]
    assert max(_ln_bwd_rel(got, ref)) <= LN_BWD_TOL[dtype]


def test_ln_bwd_refuses_bad_operands():
    z = torch.zeros(4, 768, device="cuda", dtype=torch.bfloat16)
    s = torch.zeros(4, device="cuda")
    w = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32/bf16/f16"):
        layernorm.layernorm_bwd(z.double(), z.double(), w, s, s)
    with pytest.raises(ValueError, match="mean/rstd"):
        layernorm.layernorm_bwd(z, z, w, s[:3], s)
    with pytest.raises(ValueError, match="gs"):
        layernorm.layernorm_bwd(z, z, w, s, s, z.float())
    with pytest.raises(ValueError, match="mixed devices"):
        layernorm.layernorm_bwd(z, z, w.cpu(), s, s)


def test_backward_kernels_bitwise_repeatable():
    gy, x, w, mean, rstd = _ln_bwd_inputs(torch.bfloat16, 8192, 768, 1)
    g = _g(2)
    q, k, v, do = (torch.randn(2, 4, 300, 64, generator=g, device="cuda"
                               ).bfloat16() for _ in range(4))
    o, lse = flash_fa2.fa2_flash_attention_fwd(q, k, v)
    di = (do.float() * o.float()).sum(-1)

    def ln():
        return (layernorm.layernorm_dx(gy, x, w, mean, rstd),
                *layernorm.layernorm_dwdb(gy, x, mean, rstd))

    def fa():
        return (flash_fa2.fa2_flash_attention_dq(q, k, v, do, lse, di),
                *flash_fa2.fa2_flash_attention_dkv(q, k, v, do, lse, di))

    for fn in (ln, fa):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(u, w_) for u, w_ in zip(first, second))


def test_backward_kernels_refuse_bad_operands():
    z = torch.zeros(4, 768, device="cuda", dtype=torch.float64)
    s = torch.zeros(4, device="cuda")
    with pytest.raises(ValueError, match="f32/bf16/f16"):
        layernorm.layernorm_dx(z, z, torch.ones(768, device="cuda"), s, s)
    zf = z.float()
    with pytest.raises(ValueError, match="mean/rstd"):
        layernorm.layernorm_dwdb(zf, zf, s.double(), s)
    q = torch.zeros(1, 2, 16, 48, device="cuda", dtype=torch.bfloat16)
    st = torch.zeros(1, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_fa2.fa2_flash_attention_dq(q, q, q, q, st, st)
    q = torch.zeros(1, 2, 16, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        flash_fa2.fa2_flash_attention_dkv(q, q, q, q, st.half(), st)
    with pytest.raises(ValueError, match="do"):
        flash_fa2.fa2_flash_attention_dq(q, q, q, q.float(), st, st)


def _xent_inputs(dtype, s, d, v, seed, transposed=False):
    g = _g(seed)
    x = torch.randn(s, d, generator=g, device="cuda").to(dtype)
    w = (torch.randn(d, v, generator=g, device="cuda") * 0.05).to(dtype)
    if transposed:  # the tied head's wte.t(): a (D, V) view of (V, D)
        w = w.t().contiguous().t()
    tg = torch.randint(0, v, (s,), generator=g, device="cuda")
    gs = torch.full((1,), 0.5 / s, device="cuda")
    return x, w, tg, gs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("s,d,v,transposed", [
    (257, 64, 1000, False), (1000, 768, 50257, False), (40, 1600, 3001, False),
    (300, 768, 777, True), (40, 96, 777, False), (257, 768, 1000, False),
    (33, 768, 50304, True), (63, 768, 1000, False), (64, 768, 1000, False),
    (65, 768, 1000, False), (129, 768, 50257, False), (40, 832, 3001, False),
    (129, 896, 3001, False)],
    ids=["d64", "d768_gpt2_vocab", "d1600", "wte_t", "d96_s40",
         "s257_v1000", "s33_wte_t", "s63", "s64", "s65",
         "s129_gpt2_vocab", "d832_two_slices", "d896_s129"])
def test_fused_xent_kernels(dtype, s, d, v, transposed):
    """Around the tensor-core kernels' tiles: 64 tokens a CTA (S = 63, 64,
    65, 129), 64-wide chunks of D with a second slice past 768 (832, 896)
    and a 32-column vocab tile (V not a multiple of 8 or of 32); the
    forward and dx repeat bit for bit."""
    x, w, tg, gs = _xent_inputs(dtype, s, d, v, s + d + v, transposed)
    before = (fused_xent.fused_xent_fwd.launches,
              fused_xent.fused_xent_dx.launches,
              fused_xent.fused_xent_dw.launches)
    loss, lse = fused_xent.fused_xent_fwd(x, w, tg)
    dx = fused_xent.fused_xent_dx(x, w, tg, lse, gs)
    dw = fused_xent.fused_xent_dw(x, w, tg, lse, gs)
    torch.cuda.synchronize()
    assert (fused_xent.fused_xent_fwd.launches,
            fused_xent.fused_xent_dx.launches,
            fused_xent.fused_xent_dw.launches) == tuple(n + 1 for n in before)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    ploss, plse = fused_xent._xent_fwd_plain(x, w, tg)
    # f32 sums over D in another order; f32 operands run as 3xTF32
    torch.testing.assert_close(loss, ploss, atol=1e-3, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)
    # the kernels round dz to the operand type before its product, the
    # plain versions keep it f32: relative L2 error
    for got, ref in ((dx, fused_xent._xent_dx_plain(x, w, tg, plse, gs)),
                     (dw, fused_xent._xent_dw_plain(x, w, tg, plse, gs))):
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        assert rel <= (1e-4 if dtype == torch.float32 else 1e-2)
    # a repeat, handed w as FusedXentFn hands the forward and dx: bf16 and
    # f16 the transposed view of a contiguous w^T, which they read
    wk = w if dtype == torch.float32 else w.t().contiguous().t()
    loss2, lse2 = fused_xent.fused_xent_fwd(x, wk, tg)
    dx2 = fused_xent.fused_xent_dx(x, wk, tg, lse, gs)
    torch.cuda.synchronize()
    assert torch.equal(loss2, loss) and torch.equal(lse2, lse)
    assert torch.equal(dx2, dx)


@pytest.mark.parametrize("s,d,v,transposed", [
    (257, 64, 1000, False), (1000, 768, 50257, False), (40, 1600, 3001, False),
    (300, 768, 777, True)], ids=["d64", "d768_gpt2_vocab", "d1600", "wte_t"])
def test_fused_xent_f32_against_f64(s, d, v, transposed):
    """The f32 kernels and the f32 plain versions, each against an f64
    evaluation of the same formulas: lse max abs err <= 1e-5, dx and dW
    relative L2 err <= 1e-4 (printed with -s)."""
    x, w, tg, gs = _xent_inputs(torch.float32, s, d, v, s + d + v,
                                transposed)
    _, lse64 = fused_xent._xent_fwd_plain(x.double(), w.double(), tg)
    ref = (fused_xent._xent_dx_plain(x.double(), w.double(), tg, lse64,
                                     gs.double()),
           fused_xent._xent_dw_plain(x.double(), w.double(), tg, lse64,
                                     gs.double()))
    _, lse = fused_xent.fused_xent_fwd(x, w, tg)
    _, plse = fused_xent._xent_fwd_plain(x, w, tg)
    runs = {"kernel": (lse, fused_xent.fused_xent_dx(x, w, tg, lse, gs),
                       fused_xent.fused_xent_dw(x, w, tg, lse, gs)),
            "plain": (plse, fused_xent._xent_dx_plain(x, w, tg, plse, gs),
                      fused_xent._xent_dw_plain(x, w, tg, plse, gs))}
    for name, (l, dx, dw) in runs.items():
        lse_err = float((l.double() - lse64).abs().max())
        rel = [float((a.double() - b).norm() / b.norm())
               for a, b in zip((dx, dw), ref)]
        print(f"f32 {name} vs f64 S={s} D={d} V={v}: lse max abs err "
              f"{lse_err:.3g}, dx rel L2 {rel[0]:.3g}, dW rel L2 "
              f"{rel[1]:.3g}")
        assert lse_err <= 1e-5 and max(rel) <= 1e-4, name


@pytest.mark.parametrize("n", [1, 768, 4097, 1_000_003])
@pytest.mark.parametrize("decoupled,maximize", [
    (False, False), (True, False), (False, True), (True, True)])
def test_adamw_fused_kernel(n, decoupled, maximize):
    g = _g(n)
    p, gr, m = (torch.randn(n, generator=g, device="cuda") for _ in range(3))
    v = torch.rand(n, generator=g, device="cuda") * 1e-2
    kw = dict(lr=1e-3, c1=1 - 0.9 ** 5, c2=1 - 0.999 ** 5, b1=0.9, b2=0.999,
              eps=1e-8, wd=0.1, decoupled=decoupled, maximize=maximize)
    a = [t.clone() for t in (p, gr, m, v)]
    b = [t.clone() for t in (p, gr, m, v)]
    before = adamw_fused.adamw_update_fused.launches
    adamw_fused.adamw_update_fused(*a, **kw)
    torch.cuda.synchronize()
    assert adamw_fused.adamw_update_fused.launches == before + 1
    adamw_fused._adamw_update_plain(*b, **kw)
    scale = float(b[0].abs().max())
    for i in (0, 2, 3):
        assert float((a[i] - b[i]).abs().max()) <= 1e-6 * scale


def test_fused_kernels_bitwise_repeatable():
    x, w, tg, gs = _xent_inputs(torch.bfloat16, 1000, 768, 50257, 5)
    p, gr, m = (torch.randn(1_000_003, generator=_g(6), device="cuda")
                for _ in range(3))
    v = torch.rand(1_000_003, generator=_g(7), device="cuda")

    def xent():
        loss, lse = fused_xent.fused_xent_fwd(x, w, tg)
        return (loss, lse, fused_xent.fused_xent_dx(x, w, tg, lse, gs),
                fused_xent.fused_xent_dw(x, w, tg, lse, gs))

    def adamw():
        out = [t.clone() for t in (p, gr, m, v)]
        adamw_fused.adamw_update_fused(
            *out, lr=1e-3, c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8,
            wd=0.1)
        return out

    for fn in (xent, adamw):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(u, w_) for u, w_ in zip(first, second))


def test_fused_kernels_refuse_bad_operands():
    x = torch.zeros(8, 48, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(48, 100, device="cuda", dtype=torch.bfloat16)
    tg = torch.zeros(8, dtype=torch.long, device="cuda")
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_xent.fused_xent_fwd(x, w, tg)
    with pytest.raises(ValueError, match="mixed devices"):
        fused_xent.fused_xent_fwd(x[:, :32], w[:32], tg.cpu())
    with pytest.raises(ValueError, match="one f32/bf16/f16"):
        fused_xent.fused_xent_fwd(x[:, :32], w[:32].float(), tg)
    # each C entry reads one layout of w: fused_xent_fwd / _dx w (D, V),
    # f32 only; fused_xent_fwd_wt / _dx_wt w^T (V, D), bf16/f16 only
    xs, wts = x[:, :32].contiguous(), w[:32].t().contiguous()
    tg32, st = tg.int(), torch.zeros(2, 8, device="cuda")
    ptrs = (xs.data_ptr(), wts.data_ptr(), tg32.data_ptr(), st[0].data_ptr(),
            st[1].data_ptr())
    for name, dtype in (("fused_xent_fwd", torch.bfloat16),
                        ("fused_xent_fwd_wt", torch.float32)):
        fn = _build.entry("fused_xent", name, fused_xent._FWD_ARGS)
        assert fn(*ptrs, 8, 32, 100, _build.DTYPE_CODES[dtype],
                  _build.stream_ptr(xs)) != 0, name
    z = torch.zeros(16, device="cuda")
    kw = dict(lr=1e-3, c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    with pytest.raises(ValueError, match="must be f32"):
        adamw_fused.adamw_update_fused(z.bfloat16(), z, z.clone(),
                                       z.clone(), **kw)
    with pytest.raises(ValueError, match="mixed devices"):
        adamw_fused.adamw_update_fused(z, z.cpu(), z.clone(), z.clone(),
                                       **kw)


@pytest.mark.parametrize("knobs", [
    {}, dict(fused_xent=True, fused_xent_impl="pallas"),
    dict(fused_xent=True, fused_xent_impl="pallas", tie_weights=True)],
    ids=["default", "pallas_head", "pallas_head_tied"])
def test_tiny_training_grads_match_cpu(knobs):
    """f32 tiny preset: one step's loss and gradients through every
    training kernel on the card match the CPU port's plain path."""
    import dataclasses

    import tiny_deepspeed_tpu_torch as T
    cfg = dataclasses.replace(T.GPT2_PRESETS["tiny"], **knobs)
    cpu = T.GPT2Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu = T.GPT2Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    idx = torch.randint(0, cfg.vocab_size, (2, 100), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (2, 100), generator=g)
    out = []
    for model in (cpu, gpu):
        loss = model.apply(idx.to(model.device), tgt.to(model.device))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((float(loss), [gr.cpu() for gr in grads]))
    assert abs(out[0][0] - out[1][0]) <= 1e-4
    for (name, _), a, b in zip(cpu.named_parameters(), out[0][1],
                               out[1][1]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-3, msg=name)


def test_tiny_engine_tokens_match_cpu():
    """f32 tiny preset: the card (all three kernels) and the CPU port
    (plain versions) produce the same greedy tokens."""
    import tiny_deepspeed_tpu_torch as T
    cfg = T.GPT2_PRESETS["tiny"]
    cpu = T.GPT2Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu = T.GPT2Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        eng = T.ServingEngine(model, T.ServeConfig(
            max_active=3, num_blocks=7, block_tokens=8, max_seq_tokens=64),
            device=dev)
        hs = [eng.submit(list(range(3 + i, 30 + 2 * i)), 12)
              for i in range(4)]
        eng.drain(max_ticks=500)
        outs.append([h.tokens for h in hs])
    assert outs[0] == outs[1]
    assert math.isfinite(float(gpu.apply(
        torch.zeros(1, 8, dtype=torch.long, device="cuda")).sum()))


def _quant_pool(qdt, shape, g):
    """A pool of random codes with positive f32 scales (int8 / e4m3), or a
    plain pool in `qdt` (scales None)."""
    k = torch.randn(shape, generator=g, device="cuda")
    v = torch.randn(shape, generator=g, device="cuda")
    if qdt in (torch.int8, torch.float8_e4m3fn):
        mode = "int8" if qdt == torch.int8 else "fp8"
        (qk, sk), (qv, sv) = (pool_mod._quant_vectors(a, mode) for a in (k, v))
        return pool_mod.KVPoolView(qk, qv, sk.contiguous(), sv.contiguous())
    return pool_mod.KVPoolView(k.to(qdt), v.to(qdt))


@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("qdt,kdt", [
    (torch.float32, torch.int8), (torch.bfloat16, torch.int8),
    (torch.float32, torch.float8_e4m3fn),
    (torch.bfloat16, torch.float8_e4m3fn)])
@pytest.mark.parametrize("hq,kvh,d,bt", [(12, 12, 64, 16), (4, 2, 32, 8),
                                         (2, 1, 128, 32), (12, 4, 64, 16),
                                         (32, 8, 64, 16)])
def test_paged_quant_decode_kernel(qdt, kdt, hq, kvh, d, bt, case):
    s, nl = 5, 3
    w, pos = _decode_case(case, bt)
    g = _g(hq * d + bt + 1)
    view = _quant_pool(kdt, (s * w + 1, bt, nl, kvh, d), g)
    tables = (torch.randperm(s * w, generator=g, device="cuda") + 1
              ).reshape(s, w).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    page = pool_mod.page_ref(tables, pos, bt)
    q = torch.randn(s, hq, 1, d, generator=g, device="cuda").to(qdt)
    before = (paged_attn.paged_attention.launches,
              paged_attn.paged_attention_quant.launches)
    for layer in range(nl):
        o = paged_attn.paged_attention(q, view, page, layer)
        torch.cuda.synchronize()
        po = paged_attn._paged_attention_plain(q, view, page, layer)
        assert o.dtype == qdt
        torch.testing.assert_close(o.float(), po.float(), **TOL[qdt])
    assert (paged_attn.paged_attention.launches,
            paged_attn.paged_attention_quant.launches) == (before[0],
                                                           before[1] + nl)


@pytest.mark.parametrize("qdt,kdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.float32, torch.float8_e4m3fn)])
@pytest.mark.parametrize("hq,kvh,d,bt,k1", [
    (12, 12, 64, 16, 5), (4, 2, 32, 8, 17), (2, 1, 128, 32, 3),
    (12, 12, 64, 16, 256), (12, 12, 64, 16, 16), (12, 12, 64, 16, 17),
    (4, 2, 64, 16, 64), (2, 1, 32, 16, 5),
    # llama-160m's group 3 and llama-1b's group 4: the verify span (15
    # and 20 rows: FMA, and wgmma's 64-row tiles across the groups)
    (12, 4, 64, 16, 5), (12, 4, 64, 16, 256), (32, 8, 64, 16, 5),
    (32, 8, 64, 16, 256)])
@pytest.mark.parametrize("case", ["short", "long"])
def test_paged_span_kernel(qdt, kdt, hq, kvh, d, bt, k1, case):
    """pos0 = 0, on a block boundary, mid-block and near the table's
    end; K1 not a multiple of the 16-row tile, and 16 / 17 on either
    side of the few-rows / many-rows switch; grouped heads.  "long"
    (W = 256): pos0 past several splits, one ending a split exactly
    (512 pool keys), and up to the table's end (4096 - K1 at bt 16)."""
    s, nl = 4, 2
    w = 40 if case == "short" else 256
    g = _g(hq * d + bt + k1)
    view = _quant_pool(kdt, (s * w + 1, bt, nl, kvh, d), g)
    tables = (torch.randperm(s * w, generator=g, device="cuda") + 1
              ).reshape(s, w).to(torch.int32)
    pos0 = ([0, 2 * bt, 3 * bt + 5, w * bt - k1] if case == "short"
            else [0, 512, 1000 + k1, w * bt - k1])
    pos0 = torch.tensor(pos0, dtype=torch.int32, device="cuda")
    page = pool_mod.page_ref(tables, pos0, bt)
    q = torch.randn(s, hq, k1, d, generator=g, device="cuda").to(qdt)
    sk = torch.randn(s, kvh, k1, d, generator=g, device="cuda").to(qdt)
    sv = torch.randn(s, kvh, k1, d, generator=g, device="cuda").to(qdt)
    before = paged_attn.paged_attention_span.launches
    for layer in range(nl):
        o = paged_attn.paged_attention(q, view, page, layer,
                                       span_kv=(sk, sv))
        torch.cuda.synchronize()
        po = paged_attn._paged_attention_plain(q, view, page, layer,
                                               (sk, sv))
        assert o.dtype == qdt and torch.isfinite(o).all()
        tol = TOL[qdt if kdt in (torch.float32, torch.int8,
                                 torch.float8_e4m3fn) else kdt]
        torch.testing.assert_close(o.float(), po.float(), **tol)
    assert paged_attn.paged_attention_span.launches == before + nl


def _span_inputs(qdt, kdt, k1, seed, w=64, hq=12, kvh=12, d=64, bt=16):
    s, nl = 4, 2
    g = _g(seed)
    view = _quant_pool(kdt, (s * w + 1, bt, nl, kvh, d), g)
    tables = (torch.randperm(s * w, generator=g, device="cuda") + 1
              ).reshape(s, w).to(torch.int32)
    pos0 = torch.tensor([1000, 0, 517, 64], dtype=torch.int32,
                        device="cuda")
    page = pool_mod.page_ref(tables, pos0, bt)
    q = torch.randn(s, hq, k1, d, generator=g, device="cuda").to(qdt)
    sk = torch.randn(s, kvh, k1, d, generator=g, device="cuda").to(qdt)
    sv = torch.randn(s, kvh, k1, d, generator=g, device="cuda").to(qdt)
    return q, view, page, (sk, sv)


@pytest.mark.parametrize("kdt", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("k1", [1, 5, 256])
def test_paged_repeat_bitwise(kdt, k1):
    """The split walk merges its partials in a fixed order: two calls
    give the same bits (decode at K1 = 1, the FMA span at 5, the
    tensor-core span at 256), over bf16 and int8 pools."""
    q, view, page, span = _span_inputs(torch.bfloat16, kdt, k1, k1)
    if k1 == 1:
        page = pool_mod.page_ref(page.tables, page.pos + 3, 16)
        span = None
    outs = [paged_attn.paged_attention(q, view, page, 1, span_kv=span)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("qdt,kdt,k1,want", [
    (torch.bfloat16, torch.bfloat16, 256, "paged_span_wgmma"),
    (torch.bfloat16, torch.int8, 256, "paged_span_wgmma"),
    (torch.float32, torch.float32, 256, "paged_span_fma"),
    (torch.bfloat16, torch.bfloat16, 5, "paged_span_fma"),
    (torch.bfloat16, torch.bfloat16, 1, "paged_decode_kernel")])
def test_paged_launches_one_kernel(qdt, kdt, k1, want):
    """A profiled call: a bf16 span of 256 rows runs the tensor-core
    kernel, an f32 one (and a 5-row bf16 one) the FMA kernel, decode its
    own — each call exactly one kernel on the device, and one count."""
    from torch.profiler import ProfilerActivity, profile
    q, view, page, span = _span_inputs(qdt, kdt, k1, 3)
    if k1 == 1:
        span = None
    paged_attn.paged_attention(q, view, page, 0, span_kv=span)  # built
    torch.cuda.synchronize()
    counters = (paged_attn.paged_attention, paged_attn.paged_attention_quant,
                paged_attn.paged_attention_span)
    names = []
    for _ in range(3):  # an empty CUPTI trace now and then: take another
        before = sum(c.launches for c in counters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            paged_attn.paged_attention(q, view, page, 0, span_kv=span)
            torch.cuda.synchronize()
        assert sum(c.launches for c in counters) == before + 1
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert len(names) == 1 and want in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,block,dither", [
    ("int8", 64, False), ("fp8", 64, False), ("int8", 256, True),
    ("fp8", 256, False), ("int8", 100, False)])
def test_quantize_kernel_bit_identical(dtype, mode, block, dither):
    g = _g(block + int(dither))
    n = block * 777
    x = (torch.randn(n, generator=g, device="cuda")
         * torch.logspace(-6, 6, n, device="cuda")).to(dtype)
    x[:block] = 0.0  # an all-zero block
    d = (torch.rand(n, generator=g, device="cuda") - 0.5) if dither else None
    before = quant.quantize_blockwise.launches
    q, sc = quant.quantize_blockwise(x, mode, block, d)
    torch.cuda.synchronize()
    assert quant.quantize_blockwise.launches == before + 1
    pq, psc = quant._quantize_plain(x, mode, block, d)
    assert q.dtype == pq.dtype and sc.shape == psc.shape == (n // block, 1)
    assert torch.equal(sc, psc)
    assert torch.equal(q.view(torch.uint8), pq.view(torch.uint8))


def test_quant_and_span_refuse_bad_operands():
    view = _quant_pool(torch.int8, (3, 8, 1, 2, 64), _g(0))
    page = pool_mod.page_ref(torch.ones(1, 2, dtype=torch.int32,
                                        device="cuda"),
                             torch.zeros(1, dtype=torch.int32,
                                         device="cuda"), 8)
    q = torch.zeros(1, 2, 1, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="not instantiated"):
        paged_attn.paged_attention(q, view, page, 0)
    with pytest.raises(ValueError, match="scales"):
        paged_attn.paged_attention(q.float(), view._replace(k_scale=None),
                                   page, 0)
    sk = torch.zeros(1, 2, 1, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q's dtype"):
        paged_attn.paged_attention(q.float(), view, page, 0,
                                   span_kv=(sk, sk))
    with pytest.raises(ValueError, match="multiple"):
        quant.quantize_blockwise(torch.zeros(65, device="cuda"), "int8", 64)


@pytest.mark.parametrize("knobs", [
    dict(spec_draft="ngram", spec_k=3), dict(spec_draft="model:self"),
    dict(prefix_cache=True), dict(quant="int8")],
    ids=["ngram", "model_self", "prefix", "int8"])
def test_tiny_serving_variants_match_cpu(knobs):
    """f32 tiny preset: each slice-4 engine on the card (span, quantized
    and quantizer kernels) gives the CPU port's greedy tokens."""
    import tiny_deepspeed_tpu_torch as T
    cfg = T.GPT2_PRESETS["tiny"]
    cpu = T.GPT2Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu = T.GPT2Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    shared = list(range(40, 56))
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        eng = T.ServingEngine(model, T.ServeConfig(
            max_active=3, num_blocks=12, block_tokens=8, max_seq_tokens=64,
            **knobs), device=dev)
        hs = [eng.submit(shared + list(range(3 + i, 10 + 2 * i)), 12)
              for i in range(4)]
        eng.drain(max_ticks=500)
        outs.append([h.tokens for h in hs])
        assert all(h.status == "ok" for h in hs)
    assert outs[0] == outs[1]


def _kv_pool(dtype, quant_mode, kvh, dh, g, nl=3, nb=25, bt=8):
    """A pool of `dtype` (quantized when quant_mode) filled with noise,
    so that a write to the wrong place shows."""
    view = pool_mod.PagedKVPool(
        n_layer=nl, kv_heads=kvh, head_dim=dh, num_blocks=nb - 1,
        block_tokens=bt, dtype=dtype, quant=quant_mode, device="cuda").view
    for t in view:
        if t is not None:
            pool_mod._raw(t).copy_(torch.randint(
                0, 100, t.shape, generator=g, device="cuda"))
    return view


def _kv_writer_call(writer, view, src_dtype, g):
    """(write(view) -> view) for one writer at its main path's layout:
    decode reads a column slice of a qkv product, span and prefill their
    (L, S, KVH, K1|P, Dh) stacks; invalid slots, rejected drafts and the
    padding tail point at scratch block 0; every other row has a
    destination of its own (two rows on one pool row would race)."""
    nb, bt, nl, kvh, dh = view.k.shape

    def tables(s, w):  # distinct blocks: no slot shares another's
        ids = torch.randperm(nb - 1, generator=g, device="cuda")[:s * w]
        return (ids + 1).to(torch.int32).reshape(s, w)

    if writer == "decode":
        s = 6
        qkv = torch.randn(s, 1, 3 * kvh * dh, generator=g, device="cuda")
        qkv = (qkv * 3).to(src_dtype)

        def heads1(z):
            return z.reshape(s, 1, kvh, dh).transpose(1, 2)[:, :, 0]

        k = heads1(qkv[..., kvh * dh:2 * kvh * dh])
        v = heads1(qkv[..., 2 * kvh * dh:])
        tab = tables(s, 3)
        tab[4] = 0  # an invalid slot
        pos = torch.randint(0, 3 * bt, (s,), generator=g, device="cuda",
                            dtype=torch.int32)
        page = pool_mod.page_ref(tab, pos, bt)
        return lambda vw: pool_mod.paged_append(vw, k, v, nl - 1, page)
    if writer == "span":
        s, k1 = 4, 5
        ks, vs = ((torch.randn(nl, s, kvh, k1, dh, generator=g,
                               device="cuda") * 2).to(src_dtype)
                  for _ in range(2))
        tab = tables(s, 4)
        pos0 = torch.tensor([0, 3, 7, 9], dtype=torch.int32, device="cuda")
        count = torch.tensor([5, 2, 0, 4], device="cuda")
        return lambda vw: pool_mod.paged_append_span(vw, ks, vs, tab, pos0,
                                                     count, bt)
    p = 4 * bt
    ks, vs = ((torch.randn(nl, 1, kvh, p, dh, generator=g, device="cuda")
               * 2).to(src_dtype) for _ in range(2))
    ids = torch.tensor([3, 1, 7, 0], device="cuda")  # the tail is padding
    return lambda vw: pool_mod.paged_scatter(vw, ks, vs, ids, bt)


@pytest.mark.parametrize("kvh,dh", [(12, 64), (2, 128), (2, 32)])
@pytest.mark.parametrize("src,pool,mode", [
    (torch.bfloat16, torch.bfloat16, None),
    (torch.float32, torch.float32, None),
    (torch.float32, torch.bfloat16, None),
    (torch.float16, torch.float16, None),
    (torch.bfloat16, torch.bfloat16, "int8"),
    (torch.bfloat16, torch.bfloat16, "fp8"),
    (torch.float32, torch.float32, "int8"),
    (torch.float16, torch.float16, "fp8")],
    ids=["bf16", "f32", "f32_into_bf16", "f16", "bf16_int8", "bf16_fp8",
         "f32_int8", "f16_fp8"])
@pytest.mark.parametrize("writer", ["decode", "span", "prefill"])
def test_kv_write_kernel_matches_unfused_writers(writer, src, pool, mode,
                                                  kvh, dh, monkeypatch):
    """One kv_write launch a writer call; the pool's bytes and scales on
    blocks 1.. equal the unfused writers' (the quantizer kernel and index
    writes: `_kv_write_plain` on the card) bit for bit, and those of the
    same index writes through the plain codec (`_quantize_plain`).
    Scratch block 0 holds whichever duplicate landed, in each."""
    g = _g(kvh * dh)
    fused = _kv_pool(pool, mode, kvh, dh, g)
    ref, plain = (pool_mod.KVPoolView(*(None if t is None else t.clone()
                                        for t in fused)) for _ in range(2))
    write = _kv_writer_call(writer, fused, src, g)
    before = pool_mod.kv_write.launches
    write(fused)
    torch.cuda.synchronize()
    assert pool_mod.kv_write.launches == before + 1
    qb = quant.quantize_blockwise.launches
    monkeypatch.setattr(pool_mod, "kv_write", pool_mod._kv_write_plain)
    write(ref)
    torch.cuda.synchronize()
    assert quant.quantize_blockwise.launches == qb + (2 if mode else 0)
    monkeypatch.setattr(pool_mod, "quantize_blockwise",
                        lambda x, mode, block=256, dither=None:
                        quant._quantize_plain(x, mode, block, dither))
    write(plain)
    torch.cuda.synchronize()
    assert quant.quantize_blockwise.launches == qb + (2 if mode else 0)
    for a, b, c in zip(fused, ref, plain):
        if a is not None:
            assert torch.equal(pool_mod._raw(a)[1:], pool_mod._raw(b)[1:])
            assert torch.equal(pool_mod._raw(a)[1:], pool_mod._raw(c)[1:])


def test_kv_write_refuses_bad_operands():
    view = _kv_pool(torch.bfloat16, "int8", 2, 64, _g(0))
    page = pool_mod.page_ref(torch.ones(2, 2, dtype=torch.int32,
                                        device="cuda"),
                             torch.zeros(2, dtype=torch.int32,
                                         device="cuda"), 8)
    k = torch.zeros(2, 2, 64, device="cuda", dtype=torch.bfloat16)
    strided = torch.zeros(2, 64, 2, device="cuda",
                          dtype=torch.bfloat16).transpose(1, 2)
    before = pool_mod.kv_write.launches
    with pytest.raises(ValueError, match="stride 1"):
        pool_mod.paged_append(view, strided, k, 0, page)
    with pytest.raises(ValueError, match="dtypes"):
        pool_mod.paged_append(view, k, k.float(), 0, page)
    with pytest.raises(ValueError, match="scales"):
        pool_mod.paged_append(view._replace(k_scale=None), k, k, 0, page)
    with pytest.raises(ValueError, match="layers"):
        pool_mod.paged_append(view, k, k, 3, page)
    with pytest.raises(ValueError, match="mixed devices"):
        pool_mod.paged_append(view, k, k, 0, page._replace(
            blk=page.blk.cpu()))
    with pytest.raises(ValueError, match="mixed devices"):
        pool_mod.paged_append(view._replace(v_scale=view.v_scale.cpu()),
                              k, k, 0, page)
    assert pool_mod.kv_write.launches == before


# -- slice 14: the decode append in the decode launch; the writer per layer --

APPEND_POOLS = [(torch.bfloat16, torch.bfloat16, None),
                (torch.float16, torch.float16, None),
                (torch.float32, torch.float32, None),
                (torch.float32, torch.bfloat16, None),
                (torch.bfloat16, torch.bfloat16, "int8"),
                (torch.bfloat16, torch.bfloat16, "fp8"),
                (torch.float32, torch.float32, "int8")]
APPEND_IDS = ["bf16", "f16", "f32", "f32q_bf16", "bf16_int8", "bf16_fp8",
              "f32_int8"]


def _append_inputs(qdt, pdt, mode, hq, kvh, d, case, seed, bt=16, nl=3):
    """A noisy pool, distinct blocks a slot, slot 1 invalid (an
    all-scratch table row); q, k, v the column slices of one qkv product;
    positions at offsets 0 and bt - 1 and the table's last position."""
    g = _g(seed)
    w = 6 if case == "short" else 64
    pos = ([0, 5, bt - 1, bt, w * bt - 1, 47] if case == "short"
           else [0, 5, 1023, 511, 64, w * bt - 1])
    s = len(pos)
    view = _kv_pool(pdt, mode, kvh, d, g, nl=nl, nb=s * w + 1, bt=bt)
    if mode is None:
        for t in view[:2]:
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    tables = (torch.randperm(s * w, generator=g, device="cuda") + 1
              ).reshape(s, w).to(torch.int32)
    tables[1] = 0
    page = pool_mod.page_ref(tables, torch.tensor(pos, dtype=torch.int32,
                                                  device="cuda"), bt)
    qkv = (torch.randn(s, 1, (hq + 2 * kvh) * d, generator=g, device="cuda")
           * 3).to(qdt)
    q = qkv[..., :hq * d].reshape(s, 1, hq, d).transpose(1, 2)
    k = qkv[..., hq * d:(hq + kvh) * d].reshape(s, kvh, d)
    v = qkv[..., (hq + kvh) * d:].reshape(s, kvh, d)
    return view, q, k, v, page


def _same_blocks(a, b):
    return all(x is None or torch.equal(pool_mod._raw(x)[1:],
                                        pool_mod._raw(y)[1:])
               for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("hq,kvh,d", [(12, 12, 64), (4, 2, 32), (2, 1, 128),
                                      (8, 2, 64), (12, 4, 64), (32, 8, 64)])
@pytest.mark.parametrize("qdt,pdt,mode", APPEND_POOLS, ids=APPEND_IDS)
def test_decode_append_matches_two_calls(qdt, pdt, mode, hq, kvh, d, case):
    """`paged_attention(append_kv=)` (one launch, counted in
    `paged_attention.appends`, none in kv_write's count) leaves the pool
    and the valid slots' output bit for bit as `paged_append` (kv_write)
    followed by the decode kernel."""
    view, q, k, v, page = _append_inputs(qdt, pdt, mode, hq, kvh, d, case,
                                         hq * d + kvh)
    ref = pool_mod.KVPoolView(*(None if t is None else t.clone()
                                for t in view))
    before = paged_attn.paged_attention.appends, pool_mod.kv_write.launches
    o = paged_attn.paged_attention(q, view, page, 2, append_kv=(k, v))
    torch.cuda.synchronize()
    assert (paged_attn.paged_attention.appends,
            pool_mod.kv_write.launches) == (before[0] + 1, before[1])
    pool_mod.paged_append(ref, k, v, 2, page)
    ro = paged_attn.paged_attention(q, ref, page, 2)
    torch.cuda.synchronize()
    valid = [0, 2, 3, 4, 5]
    assert torch.equal(o[valid], ro[valid])
    assert _same_blocks(view, ref)


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("mode", [None, "int8"], ids=["bf16", "int8"])
def test_decode_append_any_split(splits, mode, monkeypatch):
    """The split count forced to 1-8: whichever rank holds the decoded
    key writes it, and the result is the two calls' bit for bit."""
    plan = paged_attn.split_plan
    monkeypatch.setattr(paged_attn, "split_plan", lambda **kw: plan(
        **kw)._replace(splits=splits))
    view, q, k, v, page = _append_inputs(torch.bfloat16, torch.bfloat16,
                                         mode, 12, 12, 64, "long", splits)
    ref = pool_mod.KVPoolView(*(None if t is None else t.clone()
                                for t in view))
    o = paged_attn.paged_attention(q, view, page, 0, append_kv=(k, v))
    pool_mod.paged_append(ref, k, v, 0, page)
    ro = paged_attn.paged_attention(q, ref, page, 0)
    torch.cuda.synchronize()
    assert torch.equal(o[[0, 2, 3, 4, 5]], ro[[0, 2, 3, 4, 5]])
    assert _same_blocks(view, ref)


def test_decode_append_refuses_bad_operands():
    view, q, k, v, page = _append_inputs(torch.bfloat16, torch.bfloat16,
                                         None, 4, 2, 64, "short", 0)
    before = paged_attn.paged_attention.appends
    with pytest.raises(ValueError, match="q's dtype"):
        paged_attn.paged_attention(q, view, page, 0,
                                   append_kv=(k.float(), v.float()))
    with pytest.raises(ValueError, match="expected"):
        paged_attn.paged_attention(q, view, page, 0,
                                   append_kv=(k[:, :1], v[:, :1]))
    with pytest.raises(ValueError, match="int64"):
        paged_attn.paged_attention(q, view, page._replace(
            blk=page.blk.int()), 0, append_kv=(k, v))
    with pytest.raises(ValueError, match="mixed devices"):
        paged_attn.paged_attention(q, view, page, 0,
                                   append_kv=(k.cpu(), v.cpu()))
    with pytest.raises(ValueError, match="decode variant only"):
        span = torch.zeros(q.shape[0], 2, 1, 64, device="cuda",
                           dtype=torch.bfloat16)
        paged_attn.paged_attention(q, view, page, 0, span_kv=(span, span),
                                   append_kv=(k, v))
    assert paged_attn.paged_attention.appends == before


@pytest.mark.parametrize("kvh,dh", [(12, 64), (2, 128), (2, 32)])
@pytest.mark.parametrize("src,pool,mode", [
    (torch.bfloat16, torch.bfloat16, None),
    (torch.float32, torch.float32, None),
    (torch.float32, torch.bfloat16, None),
    (torch.bfloat16, torch.float32, None),
    (torch.float16, torch.float16, None),
    (torch.bfloat16, torch.bfloat16, "int8"),
    (torch.bfloat16, torch.bfloat16, "fp8"),
    (torch.float32, torch.float32, "int8"),
    (torch.float16, torch.float16, "fp8")],
    ids=["bf16", "f32", "f32_into_bf16", "bf16_into_f32", "f16",
         "bf16_int8", "bf16_fp8", "f32_int8", "f16_fp8"])
@pytest.mark.parametrize("writer", ["decode", "span", "prefill"])
def test_kv_write_kernel_matches_pr11_kernel(writer, src, pool, mode, kvh,
                                             dh, monkeypatch):
    """The writer (a lane group a head vector, 16-byte loads) leaves the
    pool bit for bit as the v1 kernel (`kv_write_v1`) does, from the
    same operands."""
    g = _g(kvh * dh + 1)
    view = _kv_pool(pool, mode, kvh, dh, g)
    ref = pool_mod.KVPoolView(*(None if t is None else t.clone()
                                for t in view))
    write = _kv_writer_call(writer, view, src, g)
    v1 = pool_mod.kv_write_v1
    before = v1.launches
    write(view)
    monkeypatch.setattr(pool_mod, "kv_write", v1)  # the v1 kernel
    write(ref)
    torch.cuda.synchronize()
    assert v1.launches == before + 1
    assert _same_blocks(view, ref)


@pytest.mark.parametrize("cap", [64, 5, 1])
@pytest.mark.parametrize("mode", [None, "int8"], ids=["bf16", "int8"])
def test_scatter_from_layer_views_matches_stacked(mode, cap, monkeypatch):
    """12 layers of (1, KVH, P, Dh) column slices of their own qkv
    products, as `paged_prefill` hands them over, written in one launch
    per group of `cap` layers, equal the stacked call bit for bit."""
    g = _g(cap)
    nl, kvh, dh, bt, p = 12, 4, 64, 8, 32
    view = _kv_pool(torch.bfloat16, mode, kvh, dh, g, nl=nl, nb=25, bt=bt)
    ref = pool_mod.KVPoolView(*(None if t is None else t.clone()
                                for t in view))
    d = kvh * dh
    qkvs = [(torch.randn(1, p, 3 * d, generator=g, device="cuda") * 2
             ).bfloat16() for _ in range(nl)]
    kh = [x[..., d:2 * d].reshape(1, p, kvh, dh).transpose(1, 2)
          for x in qkvs]
    vh = [x[..., 2 * d:].reshape(1, p, kvh, dh).transpose(1, 2)
          for x in qkvs]
    ids = torch.tensor([3, 9, 14, 0], device="cuda")
    pool_mod.paged_scatter(ref, torch.stack(kh), torch.stack(vh), ids, bt)
    monkeypatch.setattr(pool_mod, "MAX_LAYERS", cap)
    before = pool_mod.kv_write.launches
    pool_mod.paged_scatter(view, kh, vh, ids, bt)
    torch.cuda.synchronize()
    assert pool_mod.kv_write.launches == before + -(-nl // cap)
    assert _same_blocks(view, ref)


@pytest.mark.parametrize("src", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_kv_write_misaligned_sources(src, mode):
    """Sources one element off 16-byte alignment take element loads:
    still the v1 kernel's bits."""
    g = _g(7)
    kvh, dh = 2, 64
    view = _kv_pool(torch.bfloat16, mode, kvh, dh, g)
    ref = pool_mod.KVPoolView(*(None if t is None else t.clone()
                                for t in view))
    buf = (torch.randn(6 * 2 * kvh * dh + 1, generator=g, device="cuda")
           * 3).to(src)
    k = buf[1:1 + 6 * kvh * dh].reshape(1, 6, 1, kvh, dh)
    v = buf[1 + 6 * kvh * dh:].reshape(1, 6, 1, kvh, dh)
    blk = torch.tensor([2, 5, 0, 7, 11, 13], device="cuda")
    off = torch.tensor([0, 7, 3, 1, 2, 6], device="cuda")
    pool_mod.kv_write(view, k, v, blk, off, 1)
    pool_mod.kv_write_v1(ref, k, v, blk, off, 1)
    torch.cuda.synchronize()
    assert _same_blocks(view, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [8, 40, 512, 8192])
def test_add_layernorm_kernel_matches_composition(dtype, rows):
    """s, y, mean, rstd bit for bit `x + r` then the forward kernel, and
    the gradients of x, r, w and b bit for bit autograd's through that
    composition (LayerNormFn), for given g_s and g_y."""
    n = 768
    g = _g(rows)
    x, r, gs, gy = ((torch.randn(rows, n, generator=g, device="cuda") * 2
                     + 0.3).to(dtype) for _ in range(4))
    w, b = (torch.randn(n, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    before = layernorm.add_layernorm_fwd.launches
    got = layernorm.add_layernorm_fwd(x, r, w, b)
    assert layernorm.add_layernorm_fwd.launches == before + 1
    s = x + r
    want = (s, *layernorm.layernorm_fwd(s, w, b))
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        assert a.dtype == c.dtype and torch.equal(a, c)

    leaves = [t.clone().requires_grad_() for t in (x, r, w, b)]
    fs, fy = layernorm.add_layernorm(*leaves)
    fused = torch.autograd.grad((fs, fy), leaves, (gs, gy))
    leaves = [t.clone().requires_grad_() for t in (x, r, w, b)]
    cs = leaves[0] + leaves[1]
    cy = layernorm.layernorm(cs, leaves[2], leaves[3])
    comp = torch.autograd.grad((cs, cy), leaves, (gs, gy))
    assert torch.equal(fs, cs) and torch.equal(fy, cy)
    for a, c in zip(fused, comp):
        assert a.dtype == c.dtype and torch.equal(a, c)


LN_FWD_SHAPES = [(8, 768), (40, 768), (512, 768), (8192, 768),
                 (8192, 1600), (3, 16384), (5, 7), (5, 770), (0, 768)]
LN_FWD_DTYPES = [(torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float16, torch.float16),
                 (torch.bfloat16, torch.float32),
                 (torch.float16, torch.float32),
                 (torch.float32, torch.bfloat16)]


def _ln_fwd_inputs(rows, n, dtype, wdtype, seed):
    g = _g(seed)
    x, r = ((torch.randn(rows, n, generator=g, device="cuda") * 2 + 0.3
             ).to(dtype) for _ in range(2))
    w, b = (torch.randn(n, generator=g, device="cuda").to(wdtype)
            for _ in range(2))
    return x, r, w, b


def _ln_fwd_close(got, ref, dtype):
    y, mean, rstd = got
    py, pm, pr = ref
    assert y.dtype == dtype and y.shape == py.shape
    torch.testing.assert_close(y.float(), py.float(), **TOL[dtype])
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(rstd, pr, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("add", [False, True], ids=["fwd", "add"])
@pytest.mark.parametrize("dtype,wdtype", LN_FWD_DTYPES)
@pytest.mark.parametrize("rows,n", LN_FWD_SHAPES)
def test_ln_fwd_kernel(rows, n, dtype, wdtype, add):
    """csrc/ln_fwd.cu against `_ln_fwd_plain` / `_add_ln_fwd_plain` (s
    bit for bit `x + r`), one launch a call (none for 0 rows), two calls
    bit for bit, and the add variant bit for bit `x + r` then the forward
    kernel."""
    x, r, w, b = _ln_fwd_inputs(rows, n, dtype, wdtype, rows + n)
    fn = layernorm.add_layernorm_fwd if add else layernorm.layernorm_fwd
    args = (x, r, w, b) if add else (x, w, b)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + (1 if rows else 0)
    if add:
        s = x + r
        assert torch.equal(got[0], s)
        want = (s, *layernorm.layernorm_fwd(s, w, b))
        assert all(torch.equal(u, v) for u, v in zip(got, want))
        got = got[1:]
        ref = layernorm._add_ln_fwd_plain(x, r, w, b)[1:]
    else:
        ref = layernorm._ln_fwd_plain(x, w, b)
    _ln_fwd_close(got, ref, dtype)
    again = fn(*args)
    assert all(torch.equal(u, v) for u, v in zip(again[-3:], got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,n", [(8, 768), (512, 768), (8192, 768),
                                    (8192, 1600), (33, 1280), (33, 770),
                                    (33, 100), (2, 16384)])
def test_ln_fwd_kernel_is_the_triton_pair_bit_for_bit(rows, n, dtype):
    """The forward and the add variant give the bits of the Triton
    kernels they replaced (`_ln_fwd_triton`, `_add_ln_fwd_triton`): the
    same reduction order and the same div.full / sqrt.approx / FMA
    arithmetic, so serving's tokens and training's losses are theirs."""
    x, r, w, b = _ln_fwd_inputs(rows, n, dtype, dtype, n)
    got = layernorm.layernorm_fwd(x, w, b)
    want = layernorm._ln_fwd_triton(x, w, b, 1e-5)
    got_r = layernorm.add_layernorm_fwd(x, r, w, b)
    want_r = layernorm._add_ln_fwd_triton(x, r, w, b, 1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert all(torch.equal(u, v) for u, v in zip(got_r, want_r))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_fwd_strided_and_misaligned_rows(dtype):
    """x as a column slice of a wider buffer (a row stride, no copy) and
    r one element off a 16-byte boundary (element-wise loads): against
    the plain versions, and the Triton kernels' bits for x."""
    rows, n = 300, 768
    x, r, w, b = _ln_fwd_inputs(rows, n, dtype, dtype, 5)
    wide = torch.zeros(rows, n + 64, device="cuda", dtype=dtype)
    wide[:, :n] = x
    flat = torch.zeros(rows * n + 1, device="cuda", dtype=dtype)
    ro = flat[1:].view(rows, n)
    ro.copy_(r)
    got = layernorm.layernorm_fwd(wide[:, :n], w, b)
    _ln_fwd_close(got, layernorm._ln_fwd_plain(x, w, b), dtype)
    want = layernorm._ln_fwd_triton(wide[:, :n], w, b, 1e-5)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    s, *rest = layernorm.add_layernorm_fwd(wide[:, :n], ro, w, b)
    assert torch.equal(s, x + r)
    _ln_fwd_close(rest, layernorm._ln_fwd_plain(x + r, w, b), dtype)


def test_ln_fwd_refuses_bad_operands():
    z = torch.zeros(4, 768, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32/bf16/f16"):
        layernorm.layernorm_fwd(z.double(), w, w)
    with pytest.raises(ValueError, match="weight/bias"):
        layernorm.layernorm_fwd(z, w[:7], w)
    with pytest.raises(ValueError, match="must match x"):
        layernorm.add_layernorm_fwd(z, z.float(), w, w)
    with pytest.raises(ValueError, match="mixed devices"):
        layernorm.layernorm_fwd(z, w.cpu(), w)


def test_ring_threads_on_card_match_cpu():
    """Ring attention over four lockstep threads on one card (the chunk
    kernels) against the same ring on the CPU (their plain versions),
    grouped K/V, f32, a ragged Tl."""
    from tiny_deepspeed_tpu_torch.parallel import ring_attention as ra
    g = torch.Generator().manual_seed(9)
    q, do = (torch.randn(2, 4, 4 * 50, 64, generator=g) for _ in range(2))
    k, v = (torch.randn(2, 2, 4 * 50, 64, generator=g) for _ in range(2))

    def ring(dev):
        def rank(r, comm):
            args = [z[:, :, r * 50:(r + 1) * 50].to(dev) for z in (q, k, v)]
            o, lse = ra.ring_fwd(*args, comm)
            return (o, *ra.ring_bwd((*args, o, lse),
                                    do[:, :, r * 50:(r + 1) * 50].to(dev),
                                    comm))
        out = ra.run_lockstep(4, rank)
        return [torch.cat([o[i] for o in out], dim=2).cpu()
                for i in range(4)]

    before = flash_fa2.fa2_chunk_fwd.launches
    got = ring("cuda")
    assert flash_fa2.fa2_chunk_fwd.launches == before + 6
    for a, b in zip(got, ring("cpu")):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale + 1e-5


def test_engine_on_card_needs_nccl():
    import torch.distributed as dist

    import tiny_deepspeed_tpu_torch as T
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        model = T.GPT2Model(T.GPT2_PRESETS["tiny"])
        with pytest.raises(ValueError, match="NCCL"):
            T.DDP(model, T.AdamW())
    finally:
        dist.destroy_process_group()



# -- slice 15: RMSNorm under the LayerNorm entries' RMS flag, the Llama
# family on the card ---------------------------------------------------------

from tiny_deepspeed_tpu_torch.ops import rmsnorm  # noqa: E402

RMS_SHAPES = [(8, 768, torch.bfloat16), (512, 768, torch.bfloat16),
              (8192, 768, torch.bfloat16), (8192, 2048, torch.bfloat16),
              (8, 768, torch.float32), (512, 768, torch.float32),
              (8, 768, torch.float16), (512, 768, torch.float16),
              (37, 64, torch.bfloat16), (33, 48, torch.bfloat16),
              (65, 48, torch.float32), (7, 2048, torch.float16),
              (129, 2048, torch.float32), (5, 7, torch.bfloat16)]
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _rms_inputs(rows, n, dtype, seed, wdtype=None):
    g = _g(seed)
    x, r, gy, gs = ((torch.randn(rows, n, generator=g, device="cuda") * 2
                     + 0.3).to(dtype) for _ in range(4))
    w = (1 + 0.3 * torch.randn(n, generator=g, device="cuda")).to(
        wdtype or dtype)
    return x, r, gy, gs, w


def _rms_close(got, ref, dtype):
    scale = float(ref.float().abs().max()) + 1.0
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert float((got.float() - ref.float()).abs().max()) <= \
        RMS_TOL[dtype] * scale


@pytest.mark.parametrize("add", [False, True], ids=["rms_fwd", "add_rms"])
@pytest.mark.parametrize("rows,n,dtype", RMS_SHAPES)
def test_rms_fwd_kernel(rows, n, dtype, add):
    """`rmsnorm_fwd` / `add_rmsnorm_fwd` (csrc/ln_fwd.cu's RMS kernels)
    against their plain versions: y within 2e-2 (bf16/f16) or 1e-5 (f32)
    of the row scale, rstd within 1e-5, s bit for bit `x + r`; one launch
    a call, two calls bit for bit, the LayerNorm counters untouched."""
    x, r, _, _, w = _rms_inputs(rows, n, dtype, rows + n)
    fn = rmsnorm.add_rmsnorm_fwd if add else rmsnorm.rmsnorm_fwd
    args = (x, r, w) if add else (x, w)
    before = (fn.launches, layernorm.layernorm_fwd.launches,
              layernorm.add_layernorm_fwd.launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert (fn.launches, layernorm.layernorm_fwd.launches,
            layernorm.add_layernorm_fwd.launches) == (
                before[0] + 1, before[1], before[2])
    ref = (rmsnorm._add_rms_fwd_plain if add else rmsnorm._rms_fwd_plain)(
        *args)
    if add:
        assert torch.equal(got[0], x + r)
    _rms_close(got[-2], ref[-2], dtype)
    torch.testing.assert_close(got[-1], ref[-1], atol=1e-5, rtol=1e-5)
    again = fn(*args)
    assert all(torch.equal(u, v) for u, v in zip(again, got))


@pytest.mark.parametrize("gs", [False, True], ids=["nogs", "gs"])
@pytest.mark.parametrize("rows,n,dtype", RMS_SHAPES)
def test_rms_bwd_kernel(rows, n, dtype, gs):
    """`rmsnorm_bwd` (csrc/ln_bwd.cu's RMS kernels) against
    `_rms_bwd_plain`: dx within the dtype's tolerance of the row scale
    (with gs: bit for bit `gs + dx` of the no-gs call), dw in f32 within
    it of the column sums' scale; one launch a call, two calls bit for
    bit."""
    x, _, gy, g_s, w = _rms_inputs(rows, n, dtype, 3 * rows + n)
    rstd = rmsnorm._rms_fwd_plain(x, w)[1]
    extra = g_s if gs else None
    before = (rmsnorm.rmsnorm_bwd.launches, rmsnorm.rmsnorm_bwd.launches_gs,
              layernorm.layernorm_bwd.launches)
    dx, dw = rmsnorm.rmsnorm_bwd(gy, x, w, rstd, extra, torch.float32)
    torch.cuda.synchronize()
    assert (rmsnorm.rmsnorm_bwd.launches, rmsnorm.rmsnorm_bwd.launches_gs,
            layernorm.layernorm_bwd.launches) == (
                before[0] + 1, before[1] + gs, before[2])
    pdx, pdw = rmsnorm._rms_bwd_plain(gy, x, w, rstd, extra, torch.float32)
    _rms_close(dx, pdx, dtype)
    _rms_close(dw, pdw, dtype)
    if gs:
        dx0, _ = rmsnorm.rmsnorm_bwd(gy, x, w, rstd, None, torch.float32)
        assert torch.equal(dx, g_s + dx0)
    again = rmsnorm.rmsnorm_bwd(gy, x, w, rstd, extra, torch.float32)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.float32),
                                          (torch.float32, torch.bfloat16)])
def test_rms_mixed_dtypes_and_strided_rows(dtype, wdtype):
    """A weight in another dtype, rows of a strided view (a column slice):
    the same values as the plain versions on contiguous copies."""
    x, r, gy, _, w = _rms_inputs(64, 1536, dtype, 5, wdtype)
    xs, rs, gys = x[:, 256:1024], r[:, 256:1024], gy[:, 256:1024]
    w = w[:768].contiguous()
    y, rstd = rmsnorm.rmsnorm_fwd(xs, w)
    py, pr = rmsnorm._rms_fwd_plain(xs.contiguous(), w)
    _rms_close(y, py, dtype)
    s, y2, _ = rmsnorm.add_rmsnorm_fwd(xs, rs, w)
    assert torch.equal(s, xs + rs)
    dx, dw = rmsnorm.rmsnorm_bwd(gys, xs, w, pr)
    pdx, pdw = rmsnorm._rms_bwd_plain(gys.contiguous(), xs.contiguous(), w,
                                      pr)
    _rms_close(dx, pdx, dtype)
    _rms_close(dw, pdw, dtype if wdtype == torch.float32 else wdtype)


def test_rms_refuses_bad_operands():
    x = torch.zeros(4, 8, device="cuda")
    with pytest.raises(ValueError, match="weight"):
        rmsnorm.rmsnorm_fwd(x, torch.ones(7, device="cuda"))
    with pytest.raises(ValueError, match="rstd must be"):
        rmsnorm.rmsnorm_bwd(x, x, torch.ones(8, device="cuda"),
                            torch.ones(5, device="cuda"))


def _tiny_llama(**knobs):
    import dataclasses

    import tiny_deepspeed_tpu_torch as T
    cfg = dataclasses.replace(T.LLAMA_PRESETS["llama-tiny"], n_head=6,
                              n_kv_head=2, n_embd=192, **knobs)
    cpu = T.LlamaModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu = T.LlamaModel(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return T, cfg, cpu, gpu


@pytest.mark.parametrize("knobs", [
    {}, dict(fused_xent=True, fused_xent_impl="pallas")],
    ids=["default", "pallas_head"])
def test_tiny_llama_training_grads_match_cpu(knobs):
    """f32 tiny Llama at group 3 (6 heads of 32 over 2): one step's loss and
    gradients through the RMS entries and FA2 on the card match the CPU
    port's plain path."""
    T, cfg, cpu, gpu = _tiny_llama(**knobs)
    g = torch.Generator().manual_seed(1)
    idx = torch.randint(0, cfg.vocab_size, (2, 100), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (2, 100), generator=g)
    out = []
    before = rmsnorm.rmsnorm_bwd.launches
    for model in (cpu, gpu):
        loss = model.apply(idx.to(model.device), tgt.to(model.device))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((float(loss), [gr.cpu() for gr in grads]))
    # per layer ln_1 (no gs) and ln_2 (the add, with gs), and ln_f
    assert rmsnorm.rmsnorm_bwd.launches == before + 2 * cfg.n_layer + 1
    assert abs(out[0][0] - out[1][0]) <= 1e-4
    for (name, _), a, b in zip(cpu.named_parameters(), out[0][1],
                               out[1][1]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-3, msg=name)


@pytest.mark.parametrize("knobs", [
    {}, dict(spec_draft="ngram", spec_k=4), dict(spec_draft="model:self"),
    dict(prefix_cache=True), dict(quant="int8")],
    ids=["plain", "ngram", "model_self", "prefix", "int8"])
def test_tiny_llama_engine_tokens_match_cpu(knobs):
    """f32 tiny Llama at group 3: the card (the RMS entries, the paged
    kernels with the append, the writer) and the CPU port give the same
    greedy tokens; no LayerNorm forward launches."""
    T, cfg, cpu, gpu = _tiny_llama()
    outs = []
    before = (layernorm.layernorm_fwd.launches,
              layernorm.add_layernorm_fwd.launches,
              rmsnorm.add_rmsnorm_fwd.launches)
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        eng = T.ServingEngine(model, T.ServeConfig(
            max_active=3, num_blocks=9, block_tokens=8, max_seq_tokens=64,
            **knobs), device=dev)
        shared = list(range(5, 21))
        hs = [eng.submit((shared if knobs.get("prefix_cache") else [])
                         + list(range(3 + i, 30 + 2 * i)), 12)
              for i in range(4)]
        eng.drain(max_ticks=500)
        assert [h.status for h in hs] == ["ok"] * 4
        outs.append([h.tokens for h in hs])
    assert outs[0] == outs[1]
    assert (layernorm.layernorm_fwd.launches,
            layernorm.add_layernorm_fwd.launches) == before[:2]
    assert rmsnorm.add_rmsnorm_fwd.launches > before[2]


def _moe_pair(dispatch):
    """One MoE block at moe-8x124m's widths (D 768, 12 heads, 8 experts,
    F 3072), bf16 compute, the same weights on the CPU and the card."""
    import dataclasses

    import tiny_deepspeed_tpu_torch as T
    cfg = dataclasses.replace(T.MOE_PRESETS["moe-8x124m"], n_layer=1,
                              vocab_size=256, block_size=512,
                              moe_dispatch=dispatch)
    cpu = T.MoEGPT(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = T.MoEGPT(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _moe_block_grads(model, x, gy, remat=None):
    """The block's (y, aux) on x and the gradients of <y, gy> + aux (x's
    and the block leaves'), through the configured remat (`remat`
    overrides config.remat)."""
    import dataclasses
    cfg = model.config
    if remat is not None:
        model.config = dataclasses.replace(cfg, remat=remat)
    try:
        x = x.to(model.device).requires_grad_()
        leaves = [p for n, p in model.named_parameters()
                  if n.startswith("h.")]
        bp = model._layers(model.stacked_compute_params())[0]
        y, aux = model._block_fn()(x, bp)
        loss = (y.float() * gy.to(model.device).float()).sum() + aux
        grads = torch.autograd.grad(loss, [x] + leaves)
    finally:
        model.config = cfg
    return y.detach(), aux.detach(), grads


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_block_matches_cpu(dispatch):
    """One MoE block (512 tokens, bf16) forward and backward on the card
    against the CPU port's plain path.  bf16 LayerNorm and attention
    outputs round apart between the two, which can flip a token's
    expert choice where two probabilities nearly tie, so the CPU side is
    handed the card's choices (its gates from its own probabilities):
    at least 97% of the tokens must have chosen the same experts on
    their own; y, dx and every leaf's gradient within 3e-2 relative L2,
    the aux term within 1e-3."""
    cpu, gpu = _moe_pair(dispatch)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 512, 768, generator=g).bfloat16()
    gy = torch.randn(1, 512, 768, generator=g).bfloat16()
    picks, own = [], []

    def spy(xr, w):
        out = type(gpu)._router(gpu, xr, w)
        picks.append(out[1].cpu())
        return out

    def forced(xr, w):
        _, idx, probs = type(cpu)._router(cpu, xr, w)
        own.append(idx)
        idx = picks[len(own) - 1]
        gate = probs.gather(1, idx)
        return gate / (gate.sum(-1, keepdim=True) + 1e-9), idx, probs

    before = (layernorm.layernorm_fwd.launches,
              layernorm.add_layernorm_fwd.launches,
              flash_fa2.fa2_flash_attention_fwd.launches)
    gpu._router, cpu._router = spy, forced
    try:
        card = _moe_block_grads(gpu, x, gy, remat=False)
        plain = _moe_block_grads(cpu, x, gy, remat=False)
    finally:
        del gpu._router, cpu._router
    assert (layernorm.layernorm_fwd.launches,
            layernorm.add_layernorm_fwd.launches,
            flash_fa2.fa2_flash_attention_fwd.launches) == tuple(
                n + 1 for n in before)
    same = float((own[0] == picks[0]).all(-1).float().mean())
    assert same >= 0.97, same
    assert _rel(card[0], plain[0]) <= 3e-2
    assert abs(float(card[1]) - float(plain[1])) <= 1e-3 * float(plain[1])
    for i, (a, b) in enumerate(zip(card[2], plain[2])):
        assert _rel(a, b) <= 3e-2, (i, _rel(a, b))


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_block_remat_bit_identical(dispatch):
    """The block under remat "dots_no_batch" and without remat: the same
    bits on the card (deterministic kernels, the sort path's slot sums
    in a fixed order), also on a repeat."""
    _, gpu = _moe_pair(dispatch)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 512, 768, generator=g).bfloat16()
    gy = torch.randn(1, 512, 768, generator=g).bfloat16()
    runs = [_moe_block_grads(gpu, x, gy, remat=r)
            for r in (True, False, True)]
    for other in runs[1:]:
        assert torch.equal(other[0], runs[0][0])
        assert torch.equal(other[1], runs[0][1])
        for a, b in zip(other[2], runs[0][2]):
            assert torch.equal(a, b)
