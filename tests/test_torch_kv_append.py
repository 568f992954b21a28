# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The decode append folded into paged attention, and the pool writer fed
per layer, on the CPU.

On the card the decode step's K/V write rides in the paged-decode launch
(`ops.paged_attn.paged_attention(..., append_kv=(k, v))`, csrc/
paged_attn.cu `APPEND`) and the prefill scatter reads each layer's own
views (`serving.pool.paged_scatter` / `kv_write` with per-layer lists, a
source pointer per layer, MAX_LAYERS a launch); tests/test_torch_cuda.py
and chip_smoke.py hold both bit for bit to the two-call route and the
stacked call there.  Here their plain versions run, and must equal:

- `paged_attention(append_kv=)` the two calls `paged_append` then
  `paged_attention`, output and pool bit for bit, over f32, int8 and fp8
  pools (the plain route writes first, JAX's order), and JAX's
  `paged_append` followed by its interpret-mode Pallas `paged_attention`
  on the tiny preset's geometry (pools bit for bit on blocks 1..,
  outputs within 1e-5: the sides differ only in summation order);
- an invalid slot's row lands on scratch block 0 and nowhere else; the
  in-block offset takes 0 and bt - 1; grouped heads 4/2;
- `paged_scatter` from per-layer lists (the qkv product's strided column
  slices, as `paged_prefill` hands them over) the stacked call and JAX's
  `paged_scatter`, bit for bit, also cut into layer groups past a small
  cap;
- the host's arithmetic: `append_rank` (which CTA of a decode cluster
  writes) against `split_range` for every n and every split count 1-8,
  `layer_groups`, and `layer_sources` (a pointer per layer, one set of
  strides) against the tensors' own element addresses;
- the tiny model's paged decode step with the append fused equals the
  step with the append routed as two calls, logits and pool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu.ops.paged_attn_pallas as JPA
from tiny_deepspeed_tpu.serving import pool as jpool
from tiny_deepspeed_tpu_torch.ops import paged_attn as pa
from tiny_deepspeed_tpu_torch.serving import pool as tpool

NL, DH, BT, W = 2, 32, 4, 3  # tiny: 2 layers, head dim 32
MODES = [None, "int8", "fp8"]
MODE_IDS = ["f32", "int8", "fp8"]
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JPA, "INTERPRET", True)


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return tpool._raw(t).contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _clone(view):
    return tpool.KVPoolView(*(None if t is None else t.clone()
                              for t in view))


def _pool(mode, kvh, seed, nl=NL, nb=None, dtype=torch.float32):
    """A pool filled with noise (a write to the wrong place shows)."""
    view = tpool.PagedKVPool(n_layer=nl, kv_heads=kvh, head_dim=DH,
                             num_blocks=nb or 4 * W, block_tokens=BT,
                             dtype=dtype, quant=mode, device="cpu").view
    g = torch.Generator().manual_seed(seed)
    for t in view:
        if t is not None:
            if t.dtype in (torch.float32, torch.bfloat16):
                t.copy_(torch.randn(t.shape, generator=g))
            else:
                tpool._raw(t).copy_(torch.randint(0, 100, t.shape,
                                                  generator=g))
    return view


def _decode_inputs(hq, kvh, seed):
    """Four slots: offsets 0 and bt - 1, the table's last position, and
    an invalid slot (an all-scratch table row); q, k, v the column slices
    of one (S, 1, (Hq + 2 KVH) Dh) qkv product, as the model hands them
    over.  numpy-seeded, f32."""
    rng = np.random.default_rng(seed)
    s = 4
    tables = np.asarray([[3, 7, 1], [0, 0, 0], [9, 2, 5], [4, 12, 6]],
                        np.int32)
    pos = np.asarray([BT, 2, 2 * BT - 1, W * BT - 1], np.int32)
    qkv = (rng.standard_normal((s, (hq + 2 * kvh) * DH)) * 2).astype(
        np.float32)
    return qkv, tables, pos


def _split(qkv, hq, kvh):
    t = torch.from_numpy(qkv)
    s = t.shape[0]
    q = t[:, :hq * DH].reshape(s, hq, 1, DH)
    k = t[:, hq * DH:(hq + kvh) * DH].reshape(s, kvh, DH)
    v = t[:, (hq + kvh) * DH:].reshape(s, kvh, DH)
    return q, k, v


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("hq,kvh", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_append_equals_append_then_attention(mode, hq, kvh):
    """The fused call's plain route is the two calls, bit for bit: the
    output of every slot and every byte of the pool (scratch included:
    both routes write the same rows in the same order)."""
    qkv, tables, pos = _decode_inputs(hq, kvh, seed=hq + kvh)
    q, k, v = _split(qkv, hq, kvh)
    page = tpool.page_ref(torch.from_numpy(tables), torch.from_numpy(pos),
                          BT)
    got = _pool(mode, kvh, seed=1)
    ref = _clone(got)
    for layer in range(NL):
        o = pa.paged_attention(q, got, page, layer, append_kv=(k, v))
        tpool.paged_append(ref, k, v, layer, page)
        ro = pa.paged_attention(q, ref, page, layer)
        assert torch.equal(o, ro)
    for a, b in zip(got, ref):
        if a is not None:
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
    assert pa.paged_attention.appends == 0  # the CPU takes the plain route
    assert tpool.kv_write.launches == 0


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("hq,kvh", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_append_equals_jax(mode, hq, kvh):
    """Zeroed pools on both sides, the same numpy operands: JAX's
    `paged_append` then its Pallas `paged_attention` (interpret mode)
    leave the same pool bytes on blocks 1.., and attend to the same
    output within 1e-5, at every layer."""
    qkv, tables, pos = _decode_inputs(hq, kvh, seed=10 + hq)
    q, k, v = _split(qkv, hq, kvh)
    nb = 4 * W
    tp = tpool.PagedKVPool(n_layer=NL, kv_heads=kvh, head_dim=DH,
                           num_blocks=nb, block_tokens=BT,
                           dtype=torch.float32, quant=mode, device="cpu")
    jp = jpool.PagedKVPool(n_layer=NL, kv_heads=kvh, head_dim=DH,
                           num_blocks=nb, block_tokens=BT, dtype=jnp.float32,
                           quant=mode)
    tpage = tpool.page_ref(torch.from_numpy(tables), torch.from_numpy(pos),
                           BT)
    jpage = jpool.page_ref(jnp.asarray(tables), jnp.asarray(pos), BT)
    jq = jnp.asarray(q.numpy())
    jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
    jview = jp.view
    valid = [0, 2, 3]  # slot 1 is invalid: its output reads scratch
    for layer in range(NL):
        o = pa.paged_attention(q, tp.view, tpage, layer, append_kv=(k, v))
        jview = jpool.paged_append(jview, jk, jv, layer, jpage)
        jo = JPA.paged_attention(jq, jview, jpage, layer)
        np.testing.assert_allclose(o.numpy()[valid], np.asarray(jo)[valid],
                                   **TOL)
    for a, b in zip(tp.view, jview):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_bytes(a)[1:], _bytes(b)[1:])


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_append_lands_at_its_row_and_invalid_slots_on_scratch(mode):
    """Each valid slot's K/V land at (table block, pos % bt) — offsets 0
    and bt - 1 among them — and nowhere else; the invalid slot's at
    scratch block 0; every other pool byte is untouched."""
    hq = kvh = 2
    qkv, tables, pos = _decode_inputs(hq, kvh, seed=3)
    q, k, v = _split(qkv, hq, kvh)
    page = tpool.page_ref(torch.from_numpy(tables), torch.from_numpy(pos),
                          BT)
    assert sorted(set(page.off.tolist())) == [0, 2, BT - 1]
    layer = 1
    view = _pool(mode, kvh, seed=4)
    before = _clone(view)
    pa.paged_attention(q, view, page, layer, append_kv=(k, v))
    want = _clone(before)
    tpool._write(want, (page.blk, page.off, layer), k, v)
    for a, b, c in zip(view, want, before):
        if a is None:
            continue
        np.testing.assert_array_equal(_bytes(a), _bytes(b))
        changed = np.argwhere((_bytes(a) != _bytes(c)).reshape(
            a.shape[0], a.shape[1], -1).any(-1))
        rows = {(int(bk), int(o)) for bk, o in zip(page.blk, page.off)}
        assert {tuple(r) for r in changed} <= rows
    assert int(page.blk[1]) == tpool.SCRATCH_BLOCK


def test_append_refuses_a_span():
    view = _pool(None, 2, seed=0)
    q = torch.zeros(1, 2, 3, DH)
    page = tpool.page_ref(torch.ones(1, W, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), BT)
    span = (torch.zeros(1, 2, 3, DH),) * 2
    kv = (torch.zeros(1, 2, DH),) * 2
    with pytest.raises(ValueError, match="decode variant only"):
        pa.paged_attention(q, view, page, 0, span_kv=span, append_kv=kv)


# -- the prefill scatter, per layer -------------------------------------------

def _prefill_views(nl, kvh, p, seed, dtype):
    """Each layer's (1, KVH, P, Dh) K and V: strided column slices of its
    own (1, P, 3 KVH Dh) qkv product, as `_block(return_kv=True)` makes
    them; numpy-seeded."""
    rng = np.random.default_rng(seed)
    qkvs = [torch.from_numpy((rng.standard_normal((1, p, 3 * kvh * DH)) * 2)
                             .astype(np.float32)).to(dtype)
            for _ in range(nl)]
    d = kvh * DH

    def heads(z):
        return z.reshape(1, p, kvh, DH).transpose(1, 2)

    ks = [heads(x[..., d:2 * d]) for x in qkvs]
    vs = [heads(x[..., 2 * d:]) for x in qkvs]
    assert not ks[0].is_contiguous()
    return ks, vs


POOLS = [(torch.float32, None), (torch.bfloat16, None),
         (torch.float32, "int8"), (torch.bfloat16, "fp8")]
POOL_IDS = ["f32", "bf16", "f32_int8", "bf16_fp8"]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("cap", [None, 1, 2], ids=["one_launch", "cap1",
                                                   "cap2"])
@pytest.mark.parametrize("dtype,mode", POOLS, ids=POOL_IDS)
def test_scatter_lists_equal_stacked_and_jax(dtype, mode, cap, monkeypatch):
    """5 layers from per-layer lists (cut into groups of `cap` layers when
    given: launches of at most `cap` on the card) leave the pool as the
    stacked (L, 1, KVH, P, Dh) call does, bit for bit everywhere, and as
    JAX's `paged_scatter` does on blocks 1..; the tail block is padding
    (scratch)."""
    nl, kvh, p = 5, 2, 3 * BT
    ks, vs = _prefill_views(nl, kvh, p, seed=nl + len(POOL_IDS), dtype=dtype)
    ids = torch.tensor([7, 2, 0])
    got = _pool(mode, kvh, seed=5, nl=nl, dtype=dtype)
    ref = _clone(got)
    tpool.paged_scatter(ref, torch.stack(ks), torch.stack(vs), ids, BT)
    if cap is not None:
        monkeypatch.setattr(tpool, "MAX_LAYERS", cap)
    assert tpool.paged_scatter(got, ks, vs, ids, BT) is got
    for a, b in zip(got, ref):
        if a is not None:
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
    tp = tpool.PagedKVPool(n_layer=nl, kv_heads=kvh, head_dim=DH,
                           num_blocks=4 * W, block_tokens=BT, dtype=dtype,
                           quant=mode, device="cpu")
    jp = jpool.PagedKVPool(n_layer=nl, kv_heads=kvh, head_dim=DH,
                           num_blocks=4 * W, block_tokens=BT,
                           dtype=JDT[dtype], quant=mode)
    tpool.paged_scatter(tp.view, ks, vs, ids, BT)
    jk = jnp.asarray(torch.stack(ks).float().numpy()).astype(JDT[dtype])
    jv = jnp.asarray(torch.stack(vs).float().numpy()).astype(JDT[dtype])
    jview = jpool.paged_scatter(jp.view, jk, jv, jnp.asarray(ids.numpy()),
                                BT)
    for a, b in zip(tp.view, jview):
        if a is not None:
            np.testing.assert_array_equal(_bytes(a)[1:], _bytes(b)[1:])


def test_scatter_refuses_lists_of_unequal_layers():
    ks, vs = _prefill_views(2, 2, 2 * BT, seed=0, dtype=torch.float32)
    view = _pool(None, 2, seed=0)
    with pytest.raises(ValueError, match="share shape"):
        tpool.layer_sources([ks[0], ks[1].contiguous()])
    with pytest.raises(ValueError, match="whole"):
        tpool.paged_scatter(view, [k[:, :, 1:] for k in ks],
                            [v[:, :, 1:] for v in vs], torch.tensor([1]),
                            BT)


# -- the host's arithmetic ---------------------------------------------------

@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("tile", [64, 16])
def test_append_rank_is_the_share_that_holds_the_last_key(splits, tile):
    """For every live count n, exactly one rank's share of the tiles
    (`split_range`, the kernels' arithmetic) holds key n - 1, and it is
    `append_rank`'s."""
    for n in range(1, 40 * tile + 2):
        ntiles = -(-n // tile)
        last = (n - 1) // tile
        holders = [r for r in range(splits)
                   if pa.split_range(ntiles, splits, r)[0] <= last
                   < pa.split_range(ntiles, splits, r)[1]]
        assert holders == [pa.append_rank(n, splits, tile)]


def test_layer_groups_cover_every_layer_once():
    for cap in (1, 2, 3, 7, 64):
        for lc in range(1, 140):
            got = tpool.layer_groups(lc, cap)
            assert got[0][0] == 0 and got[-1][1] == lc
            assert all(b - a <= cap and b > a for a, b in got)
            assert all(b == a2 for (_, b), (a2, _) in zip(got, got[1:]))
            assert len(got) == -(-lc // cap)


@pytest.mark.parametrize("form", ["stacked", "stacked_strided", "lists"])
def test_layer_sources_address_every_element(form):
    """A pointer per layer and one set of element strides reach every
    source element where it lies: address(l) + (r1 s1 + r2 s2 + h sh) *
    itemsize is the element's own address, for a stacked tensor, a
    strided (transposed) stack and the prefill's per-layer views."""
    kvh, p = 2, 2 * BT
    ks, _ = _prefill_views(3, kvh, p, seed=1, dtype=torch.bfloat16)
    rows = [k.transpose(1, 2) for k in ks]  # (1, P, KVH, Dh) each
    if form == "stacked":
        xs = torch.stack(rows)
    elif form == "stacked_strided":
        xs = torch.stack(ks).transpose(2, 3)
    else:
        xs = rows
    shape, strides, addrs = tpool.layer_sources(xs)
    assert shape == (1, p, kvh, DH) and strides[-1] == 1
    assert len(addrs) == 3
    item = rows[0].element_size()
    for l in range(3):
        layer = xs[l]
        for r1 in range(shape[0]):
            for r2 in (0, 1, p - 1):
                for h in range(kvh):
                    want = layer[r1, r2, h].data_ptr()
                    got = addrs[l] + (r1 * strides[0] + r2 * strides[1]
                                      + h * strides[2]) * item
                    assert got == want


# -- the model's decode step -------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_model_decode_fused_equals_two_calls(mode, monkeypatch):
    """The tiny model's paged decode step (the append through
    `paged_attention(append_kv=)`) equals the same step with the append
    routed as `paged_append` then `paged_attention`: hidden state and
    pool, bit for bit."""
    import tiny_deepspeed_tpu_torch as T
    from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    model = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu").init(
        torch.Generator().manual_seed(0))
    c = model.config
    stacked = model.stacked_compute_params()
    tables = torch.tensor([[1, 2, 3], [4, 5, 6], [0, 0, 0]],
                          dtype=torch.int32)
    pos = torch.tensor([5, 0, 3], dtype=torch.int32)
    page = tpool.page_ref(tables, pos, BT)
    tok = torch.tensor([7, 100, 3])
    view = tpool.PagedKVPool(n_layer=c.n_layer, kv_heads=c.n_head,
                             head_dim=c.head_dim, num_blocks=8,
                             block_tokens=BT, dtype=torch.float32,
                             quant=mode, device="cpu").view
    ref = _clone(view)
    x, _ = model.paged_decode(stacked, model._embed_decode(tok, pos), view,
                              page)

    def two_calls(q, v, pg, l, span_kv=None, append_kv=None):
        if append_kv is not None:
            tpool.paged_append(v, *append_kv, l, pg)
        return pa.paged_attention(q, v, pg, l, span_kv=span_kv)

    monkeypatch.setattr(gpt2_mod, "paged_attention", two_calls)
    rx, _ = model.paged_decode(stacked, model._embed_decode(tok, pos), ref,
                               page)
    assert torch.equal(x, rx)
    for a, b in zip(view, ref):
        if a is not None:
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
