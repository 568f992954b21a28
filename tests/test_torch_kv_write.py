# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The KV-pool write (`serving/pool.kv_write`) on the CPU: its plain
version against the unfused writers and against the JAX package's.

On the card every pool writer is one launch of csrc/kv_write.cu, held
bit for bit to `_kv_write_plain` (tests/test_torch_cuda.py,
chip_smoke.py).  Here the writers run that plain version, and it must
leave the pool as the unfused writers do — `_write` on the slabs that
`paged_append`, `paged_append_span` and `paged_scatter` cut, copied
below — and as the JAX writers (`tiny_deepspeed_tpu/serving/pool.py`)
do, on the tiny preset's geometry (2 layers, 2 kv heads, head dim 32),
over f32 and bf16 pools, plain or int8 / fp8, with the decode source a
column slice of a qkv product as the model hands it over.  Scratch block
0 takes the writes of invalid slots, rejected drafts and padding, many
rows to one place; which lands is undefined, so blocks 1.. (and their
scales) are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.serving import pool as jpool
from tiny_deepspeed_tpu_torch.serving import pool as tpool

NL, KVH, DH, NB, BT = 2, 2, 32, 12, 4  # tiny: 2 layers, 2 heads of 32
POOLS = [(torch.float32, None), (torch.bfloat16, None),
         (torch.float32, "int8"), (torch.float32, "fp8"),
         (torch.bfloat16, "int8"), (torch.bfloat16, "fp8")]
POOL_IDS = ["f32", "bf16", "f32_int8", "f32_fp8", "bf16_int8", "bf16_fp8"]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bytes(t):
    """A pool tensor as comparable numpy bytes, from either side."""
    if isinstance(t, torch.Tensor):
        return tpool._raw(t).contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _noise_pool(dtype, mode, seed):
    view = tpool.PagedKVPool(n_layer=NL, kv_heads=KVH, head_dim=DH,
                             num_blocks=NB, block_tokens=BT, dtype=dtype,
                             quant=mode, device="cpu").view
    g = torch.Generator().manual_seed(seed)
    for t in view:
        if t is not None:
            tpool._raw(t).copy_(torch.randint(0, 100, t.shape, generator=g))
    return view


def _clone(view):
    return tpool.KVPoolView(*(None if t is None else t.clone()
                              for t in view))


def _inputs(writer, dtype, seed):
    """numpy-seeded writer operands: (torch args, JAX args).  The decode
    source is a column slice of a (S, 1, 3*KVH*DH) qkv product (strided);
    span and prefill sources are their (L, S, KVH, K1|P, Dh) stacks."""
    rng = np.random.default_rng(seed)
    d = KVH * DH
    if writer == "decode":
        s = 3
        qkv = (rng.standard_normal((s, 1, 3 * d)) * 3).astype(np.float32)
        tables = np.asarray([[2, 5, 7], [0, 0, 0], [9, 1, 11]], np.int32)
        pos = np.asarray([6, 0, 9], np.int32)  # slot 1 invalid: scratch
        tq = torch.from_numpy(qkv).to(dtype)

        def heads1(z):
            return z.reshape(s, 1, KVH, DH).transpose(1, 2)[:, :, 0]

        tk, tv = heads1(tq[..., d:2 * d]), heads1(tq[..., 2 * d:])
        assert not tk.is_contiguous()
        tpage = tpool.page_ref(torch.from_numpy(tables),
                               torch.from_numpy(pos), BT)
        jq = jnp.asarray(qkv).astype(JDT[dtype])
        jk = jq[:, 0, d:2 * d].reshape(s, KVH, DH)
        jv = jq[:, 0, 2 * d:].reshape(s, KVH, DH)
        jpage = jpool.page_ref(jnp.asarray(tables), jnp.asarray(pos), BT)
        return (tk, tv, 1, tpage), (jk, jv, 1, jpage)
    if writer == "span":
        s, k1 = 3, 5
        ks, vs = ((rng.standard_normal((NL, s, KVH, k1, DH)) * 2).astype(
            np.float32) for _ in range(2))
        tables = np.asarray([[3, 4, 6], [8, 10, 0], [12, 0, 0]], np.int32)
        pos0 = np.asarray([2, 4, 1], np.int32)
        count = np.asarray([5, 2, 0], np.int32)  # slot 2 commits nothing
        t = (torch.from_numpy(ks).to(dtype), torch.from_numpy(vs).to(dtype),
             torch.from_numpy(tables), torch.from_numpy(pos0),
             torch.from_numpy(count), BT)
        j = (jnp.asarray(ks).astype(JDT[dtype]),
             jnp.asarray(vs).astype(JDT[dtype]), jnp.asarray(tables),
             jnp.asarray(pos0), jnp.asarray(count), BT)
        return t, j
    p = 3 * BT
    ks, vs = ((rng.standard_normal((NL, 1, KVH, p, DH)) * 2).astype(
        np.float32) for _ in range(2))
    ids = np.asarray([7, 2, 0], np.int32)  # the tail is padding: scratch
    t = (torch.from_numpy(ks).to(dtype), torch.from_numpy(vs).to(dtype),
         torch.from_numpy(ids), BT)
    j = (jnp.asarray(ks).astype(JDT[dtype]),
         jnp.asarray(vs).astype(JDT[dtype]), jnp.asarray(ids), BT)
    return t, j


# -- the unfused writers: `_write` on the slabs each writer cut ---------------

def _unfused_append(view, k, v, l, page):
    return tpool._write(view, (page.blk, page.off, l), k, v)


def _unfused_span(view, ks, vs, tables, pos0, count, block_tokens):
    L, S, kvh, K1, dh = ks.shape
    j = torch.arange(K1)[None, :]
    wpos = pos0.long()[:, None] + j
    valid = j < count.long()[:, None]
    bidx = torch.clamp(torch.div(wpos, block_tokens, rounding_mode="floor"),
                       max=tables.shape[1] - 1)
    blk = torch.where(valid, torch.gather(tables.long(), 1, bidx),
                      tpool.SCRATCH_BLOCK)
    off = torch.where(valid, wpos % block_tokens, 0)

    def prep(a):
        return a.permute(1, 3, 0, 2, 4).reshape(S * K1, L, kvh, dh)

    return tpool._write(view, (blk.reshape(-1), off.reshape(-1)), prep(ks),
                        prep(vs))


def _unfused_scatter(view, ks, vs, block_ids, block_tokens):
    def prep(a):
        L, _, kvh, p, dh = a.shape
        a = a[:, 0].permute(2, 0, 1, 3)
        return a.reshape(p // block_tokens, block_tokens, L, kvh, dh)

    return tpool._write(view, block_ids.long(), prep(ks), prep(vs))


WRITERS = {"decode": (tpool.paged_append, _unfused_append,
                      jpool.paged_append),
           "span": (tpool.paged_append_span, _unfused_span,
                    jpool.paged_append_span),
           "prefill": (tpool.paged_scatter, _unfused_scatter,
                       jpool.paged_scatter)}


def _assert_blocks_equal(a, b):
    """Blocks 1.. of every pool tensor (codes as bytes, scales) equal."""
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(_bytes(x)[1:], _bytes(y)[1:])


@pytest.mark.parametrize("dtype,mode", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("writer", list(WRITERS))
def test_writer_equals_unfused_writer(writer, dtype, mode):
    """The writer through `kv_write`'s plain version leaves a noisy pool
    exactly as `_write` on the writer's own slabs does."""
    ours, unfused, _ = WRITERS[writer]
    targs, _ = _inputs(writer, dtype, seed=len(writer))
    got = _noise_pool(dtype, mode, seed=3)
    ref = _clone(got)
    assert ours(got, *targs) is got  # in place
    unfused(ref, *targs)
    _assert_blocks_equal(got, ref)
    assert tpool.kv_write.launches == 0  # the CPU takes the plain version


@pytest.mark.parametrize("dtype,mode", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("writer", list(WRITERS))
def test_writer_equals_jax(writer, dtype, mode):
    """Zeroed pools on both sides, the same numpy operands: the torch
    writer's pool equals the JAX writer's on blocks 1.. (codes bit for
    bit through the same blockwise codec, scales equal)."""
    ours, _, theirs = WRITERS[writer]
    targs, jargs = _inputs(writer, dtype, seed=10 + len(writer))
    tp = tpool.PagedKVPool(n_layer=NL, kv_heads=KVH, head_dim=DH,
                           num_blocks=NB, block_tokens=BT, dtype=dtype,
                           quant=mode, device="cpu")
    jp = jpool.PagedKVPool(n_layer=NL, kv_heads=KVH, head_dim=DH,
                           num_blocks=NB, block_tokens=BT, dtype=JDT[dtype],
                           quant=mode)
    ours(tp.view, *targs)
    jv = theirs(jp.view, *jargs)
    assert tpool.quant_mode(tp.view) == jpool.quant_mode(jv) == mode
    _assert_blocks_equal(tp.view, jv)


@pytest.mark.parametrize("dtype,mode", POOLS, ids=POOL_IDS)
def test_layer_range_equals_per_layer_appends(dtype, mode):
    """kv_write over layers [l0, l0 + lc) is the per-layer appends: here
    layers 1..2 of a 3-layer pool, rows as (R1, R2) = (2, 3)."""
    view = tpool.PagedKVPool(n_layer=3, kv_heads=KVH, head_dim=DH,
                             num_blocks=NB, block_tokens=BT, dtype=dtype,
                             quant=mode, device="cpu").view
    ref = _clone(view)
    rng = np.random.default_rng(5)
    ks, vs = (torch.from_numpy(rng.standard_normal(
        (2, 2, 3, KVH, DH)).astype(np.float32)).to(dtype) for _ in range(2))
    blk = torch.tensor([1, 4, 4, 9, 2, 11])
    off = torch.tensor([0, 1, 3, 2, 2, 0])
    tpool.kv_write(view, ks, vs, blk, off, 1)
    for l in range(2):
        tpool._write(ref, (blk, off, 1 + l), ks[l].reshape(6, KVH, DH),
                     vs[l].reshape(6, KVH, DH))
    _assert_blocks_equal(view, ref)


@pytest.mark.parametrize("p,block_tokens", [(BT + 1, BT), (BT, BT // 2)],
                         ids=["partial_block", "other_block_size"])
def test_scatter_refuses_what_is_not_whole_pool_blocks(p, block_tokens):
    view = _noise_pool(torch.float32, None, seed=0)
    ks = torch.zeros(NL, 1, KVH, p, DH)
    with pytest.raises(ValueError, match="whole"):
        tpool.paged_scatter(view, ks, ks, torch.tensor([1, 2]),
                            block_tokens)


@pytest.mark.parametrize("operand", ["vs", "blk", "off", "k_scale"])
def test_kv_write_refuses_operands_on_another_device(operand):
    """Every operand's device decides the path, not the sources' alone:
    one on another device (here `meta`) raises before anything is read or
    written."""
    view = _noise_pool(torch.float32, "int8", seed=0)
    src = torch.zeros(1, 2, 1, KVH, DH)
    args = dict(ks=src, vs=src.clone(), blk=torch.tensor([1, 2]),
                off=torch.tensor([0, 1]))
    if operand == "k_scale":
        view = view._replace(k_scale=view.k_scale.to("meta"))
    else:
        args[operand] = args[operand].to("meta")
    with pytest.raises(ValueError, match="mixed devices"):
        tpool.kv_write(view, args["ks"], args["vs"], args["blk"],
                       args["off"], 0)
