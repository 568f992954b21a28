# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Paged KV cache: one preallocated pool, per-request block tables.

Counterpart of `tiny_deepspeed_tpu/serving/pool.py`.  The pool is ONE
(num_blocks + 1, block_tokens, L, KVH, Dh) K/V pair carved into
`block_tokens`-token blocks; a request owns just the blocks its length
needs, listed in its host-side block table.  Physical block 0 is SCRATCH:
never allocated, it absorbs the writes of invalid slots and
bucket-padding positions so every step stays branch-free; every read
masks by true position.

The JAX functions return a new `KVPoolView` (the compiled steps donate
the old one).  Here the writers update the pool tensors IN PLACE and
return the same view — no copy of the pool per step.

Quantized blocks (`quant="int8" | "fp8"`) rest the pool at 1 byte an
element: the blockwise-absmax codec (ops/quant.py) with the codec block =
one (Dh,) head vector and one f32 scale per (block, token, layer, head).
The codes are written, and gathered, through a uint8 view of the fp8
tensors (bit for bit; PyTorch indexes every byte type that way).
`paged_panel` dequantizes to the compute dtype (the JAX XLA path); the
paged-attention kernels dequantize in registers instead.

Every writer goes through `kv_write`: on the card ONE launch of
csrc/kv_write.cu per call (and layer group of up to MAX_LAYERS) writes
both sides — the codec and the scatter of codes and scales, or the cast
rows on a bf16/f16/f32 pool — reading the source vectors where they lie,
a pointer per layer (the prefill hands over each layer's own view, no
stack); on the CPU its plain version, the codec and index writes of
`_write`.  The decode step's append is not a writer call on the card: it
rides in the paged-decode launch (`ops.paged_attn.paged_attention(...,
append_kv=)`); `paged_append` stays for the unfused arm and for callers
outside the tick.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Union

import torch

from ..ops import _build
from ..ops.dispatch import on_cuda, require, resolve_device
from ..ops.quant import QDTYPE, quantize_blockwise

# the never-allocated block absorbing invalid-slot / padding writes
SCRATCH_BLOCK = 0

KV_QUANT_MODES = (None, "int8", "fp8")


class KVPoolView(NamedTuple):
    """The pool's device tensors.  k/v: (num_blocks, block_tokens, L, KVH,
    Dh) in the resting dtype (the cache dtype, or int8 / float8_e4m3fn
    when quantized); k_scale/v_scale: (num_blocks, block_tokens, L, KVH)
    f32 per-head-vector scales, None on the unquantized pool."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class PageRef(NamedTuple):
    """Per-slot cache coordinates for one decode step: tables (S, W)
    physical block ids (unused entries -> SCRATCH_BLOCK), blk/off (S,)
    this token's write block and in-block offset, pos (S,) each slot's
    current length (the attention mask bound)."""

    tables: torch.Tensor
    blk: torch.Tensor
    off: torch.Tensor
    pos: torch.Tensor


def page_ref(tables, pos, block_tokens: int) -> PageRef:
    """Write coordinates, once per token outside the layer loop: position
    p lands in logical block p // block_tokens at offset p %
    block_tokens.  tables (S, W) and pos (S,) are int32 (what the paged
    kernel reads); blk/off come back int64, ready to index the pool."""
    j = torch.div(pos, block_tokens, rounding_mode="floor").long()
    blk = torch.gather(tables, 1, j[:, None])[:, 0].long()
    return PageRef(tables, blk, (pos % block_tokens).long(), pos)


def quant_mode(view: KVPoolView) -> Optional[str]:
    """The pool's quantization mode, read off its dtypes."""
    if view.k_scale is None:
        return None
    return "int8" if view.k.dtype == torch.int8 else "fp8"


def _raw(t):
    """The tensor as its writers and gathers index it: fp8 through a
    uint8 view (bit for bit), every other dtype as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _quant_vectors(x, mode: str):
    """(..., Dh) -> (codes same shape, scales (...,)) via the blockwise
    codec with codec block = the Dh head vector, round-to-nearest (KV
    vectors are read many times, so dither buys nothing).  On the card
    the Triton kernel reads x in its own dtype."""
    dh = x.shape[-1]
    q, s = quantize_blockwise(x.reshape(-1), mode, block=dh)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def _write(view: KVPoolView, idx, k, v) -> KVPoolView:
    """view.k[idx] = k and view.v[idx] = v, in place — quantized through
    the codec (codes and scales) on a quantized pool."""
    mode = quant_mode(view)
    if mode is None:
        view.k[idx] = k.to(view.k.dtype)
        view.v[idx] = v.to(view.v.dtype)
        return view
    for pool, scale, x in ((view.k, view.k_scale, k),
                           (view.v, view.v_scale, v)):
        q, sc = _quant_vectors(x, mode)
        _raw(pool)[idx] = _raw(q)
        scale[idx] = sc
    return view


def _stacked(xs):
    """A writer's source as one (lc, R1, R2, KVH, Dh) tensor: a list of
    per-layer tensors stacked (the plain version's way, as JAX's)."""
    return xs if isinstance(xs, torch.Tensor) else torch.stack(list(xs))


def _kv_write_plain(view: KVPoolView, ks, vs, blk, off, l0: int):
    """`kv_write` as index writes: the rows gathered into (rows, lc, KVH,
    Dh) slabs (whole (blocks, bt, ...) slabs when off is None) and
    written by `_write` — on a quantized pool through `quantize_blockwise`
    and four index writes."""
    ks, vs = _stacked(ks), _stacked(vs)
    lc, r1, r2, kvh, dh = ks.shape
    lay = slice(l0, l0 + lc)

    def rows(a):
        a = a.permute(1, 2, 0, 3, 4).reshape(r1 * r2, lc, kvh, dh)
        return a if off is not None else a.reshape(
            -1, view.k.shape[1], lc, kvh, dh)

    idx = (blk, off, lay) if off is not None else (blk, slice(None), lay)
    return _write(view, idx, rows(ks), rows(vs))


# layers one launch of csrc/kv_write.cu takes (kMaxLayers: a source
# pointer per layer and side rides in the kernel's arguments)
MAX_LAYERS = 64


def layer_sources(xs):
    """A writer call's K (or V) source as the kernel reads it: the
    per-layer (R1, R2, KVH, Dh) shape, its element strides (one set for
    every layer) and each layer's address.  xs: a stacked (lc, R1, R2,
    KVH, Dh) tensor, or a sequence of lc (R1, R2, KVH, Dh) tensors of one
    shape, dtype and strides (the prefill's per-layer views)."""
    if isinstance(xs, torch.Tensor):
        base, step = xs.data_ptr(), xs.stride(0) * xs.element_size()
        return (tuple(xs.shape[1:]), xs.stride()[1:],
                [base + l * step for l in range(xs.shape[0])])
    first = xs[0]
    require(all(t.shape == first.shape and t.stride() == first.stride()
                and t.dtype == first.dtype for t in xs),
            "kv_write: per-layer sources must share shape, dtype and "
            "strides")
    return tuple(first.shape), first.stride(), [t.data_ptr() for t in xs]


def layer_groups(lc: int, cap: int):
    """[l0, l1) layer ranges of at most `cap` layers covering lc: the
    launches of one writer call."""
    return [(a, min(a + cap, lc)) for a in range(0, lc, cap)]


def _check_write(view: KVPoolView, shape, dtype, stride, blk, off, l0, lc,
                 vshape, vdtype, vstride, what):
    """The operand checks both CUDA writers make."""
    r1, r2, kvh, dh = shape
    nb, bt, nl, pkvh, pdh = view.k.shape
    quant = view.k_scale is not None
    require(vshape == shape and (kvh, dh) == (pkvh, pdh)
            and view.v.shape == view.k.shape,
            lambda: f"{what}: source {shape} / {vshape} per layer vs pool "
            f"{tuple(view.k.shape)}")
    require(dtype == vdtype and dtype in _SRC_DTYPES,
            lambda: f"{what}: source dtypes {dtype}/{vdtype} (f32, bf16 "
            "or f16, equal)")
    require(stride[-1] == 1 and vstride[-1] == 1,
            f"{what}: a head vector must be contiguous (stride 1)")
    require(view.k.dtype == view.v.dtype and view.k.is_contiguous()
            and view.v.is_contiguous(),
            f"{what}: the k/v pools must be contiguous, of one dtype")
    require(quant == (view.k.dtype in (torch.int8, torch.float8_e4m3fn))
            and (view.v_scale is not None) == quant,
            lambda: f"{what}: a {view.k.dtype} pool needs scales iff it "
            "is int8/e4m3")
    if quant:
        require(view.k_scale.shape == view.k.shape[:-1]
                and view.v_scale.shape == view.k.shape[:-1]
                and view.k_scale.dtype == view.v_scale.dtype == torch.float32
                and view.k_scale.is_contiguous()
                and view.v_scale.is_contiguous(),
                f"{what}: scales must be contiguous f32 (NB, bt, L, KVH)")
    rows = r1 * r2
    div = 1 if off is not None else bt
    require(blk.dtype == torch.int64 and blk.is_contiguous()
            and blk.numel() * div == rows
            and (off is None or (off.dtype == torch.int64
                                 and off.is_contiguous()
                                 and off.numel() == rows)),
            lambda: f"{what}: blk/off must be contiguous int64 for {rows} "
            "rows")
    require(0 <= l0 and l0 + lc <= nl and dh <= 128,
            lambda: f"{what}: layers [{l0}, {l0 + lc}) of {nl}, Dh {dh} "
            "<= 128")
    return rows, div


_KV_WRITE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 6
                  + [ctypes.c_int] * 12 + [ctypes.c_void_p])
_KV_WRITE_V1_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 8
                     + [ctypes.c_int] * 12 + [ctypes.c_void_p])
_SRC_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _same_device(view, blk, off, *srcs):
    dev = srcs[0].device
    require(all(t is None or t.device == dev
                for t in (*srcs, *view, blk, off)),
            lambda: f"kv_write: every operand must lie on {dev}")


def _kv_write_cuda(view: KVPoolView, ks, vs, blk, off, l0: int):
    """One launch of csrc/kv_write.cu for at most MAX_LAYERS layers."""
    (kshape, kst, kptr), (vshape, vst, vptr) = (layer_sources(ks),
                                               layer_sources(vs))
    lc = len(kptr)
    require(len(vptr) == lc and 1 <= lc <= MAX_LAYERS,
            lambda: f"kv_write: {lc} / {len(vptr)} layers a launch (1 to "
            f"{MAX_LAYERS}, equal)")
    first = ks if isinstance(ks, torch.Tensor) else ks[0]
    vfirst = vs if isinstance(vs, torch.Tensor) else vs[0]
    rows, div = _check_write(view, kshape, first.dtype, kst, blk, off, l0,
                             lc, vshape, vfirst.dtype, vst, "kv_write")
    r1, r2, kvh, dh = kshape
    nb, bt, nl = view.k.shape[:3]
    require(dh in (32, 64, 128) and all(
        t.data_ptr() % 16 == 0 for t in (view.k, view.v)),
            lambda: f"kv_write: head dim {dh} not in (32, 64, 128), or a "
            "pool not 16-byte aligned")
    quant = view.k_scale is not None
    fn = _build.entry("kv_write", "kv_write", _KV_WRITE_ARGS)
    arr = ctypes.c_void_p * lc
    err = fn(arr(*kptr), arr(*vptr), view.k.data_ptr(), view.v.data_ptr(),
             view.k_scale.data_ptr() if quant else None,
             view.v_scale.data_ptr() if quant else None, blk.data_ptr(),
             None if off is None else off.data_ptr(),
             kst[0], kst[1], kst[2], vst[0], vst[1], vst[2],
             rows, r2, lc, kvh, dh, div, bt, nb, nl, int(l0),
             _build.DTYPE_CODES[first.dtype], _build.POOL_CODES[view.k.dtype],
             _build.stream_ptr(first))
    _build.check(err, "kv_write")
    kv_write.launches += 1
    return view


def kv_write(view: KVPoolView, ks, vs, blk, off, l0: int) -> KVPoolView:
    """Store K/V head vectors in the pool, in place, both sides at once.
    ks/vs: (lc, R1, R2, KVH, Dh) tensors, or sequences of lc (R1, R2,
    KVH, Dh) tensors of one shape and strides (a layer each, read where it
    lies), any strides with the head vector contiguous: row r = (r // R2,
    r % R2) of layer l goes to (blk[r], off[r], l0 + l), or with off None
    to (blk[r // bt], r % bt, l0 + l) — whole blocks.  Quantized (codes
    and scales) on an int8/fp8 pool, cast to the pool's dtype otherwise.
    CUDA tensors launch csrc/kv_write.cu once per group of up to
    MAX_LAYERS layers (or raise); CPU tensors take `_kv_write_plain`, by
    the same groups."""
    srcs = (ks,) if isinstance(ks, torch.Tensor) else tuple(ks)
    vsrcs = (vs,) if isinstance(vs, torch.Tensor) else tuple(vs)
    cuda = on_cuda(*srcs, *vsrcs, *view, blk, off)
    if cuda:
        _same_device(view, blk, off, *srcs, *vsrcs)
    write = _kv_write_cuda if cuda else _kv_write_plain
    for a, b in layer_groups(len(ks), MAX_LAYERS):
        write(view, ks[a:b], vs[a:b], blk, off, l0 + a)
    return view


kv_write.launches = 0  # kernel launches (CUDA path only)


def kv_write_v1(view: KVPoolView, ks, vs, blk, off, l0: int) -> KVPoolView:
    """`kv_write` through the v1 kernel (csrc/kv_write.cu
    `kv_write_v1`, a warp a head vector), off every path: the new
    kernel's reference in bits and time.  ks/vs stacked (lc, R1, R2, KVH,
    Dh) tensors, any Dh <= 128.  CUDA tensors launch it (or raise); CPU
    tensors take `_kv_write_plain`."""
    if not on_cuda(ks, vs, *view, blk, off):
        return _kv_write_plain(view, ks, vs, blk, off, l0)
    _same_device(view, blk, off, ks, vs)
    lc = ks.shape[0]
    rows, div = _check_write(view, tuple(ks.shape[1:]), ks.dtype,
                             ks.stride()[1:], blk, off, l0, lc,
                             tuple(vs.shape[1:]), vs.dtype, vs.stride()[1:],
                             "kv_write_v1")
    r1, r2, kvh, dh = ks.shape[1:]
    nb, bt, nl = view.k.shape[:3]
    quant = view.k_scale is not None
    fn = _build.entry("kv_write", "kv_write_v1", _KV_WRITE_V1_ARGS)
    sk, sv = ks.stride(), vs.stride()
    err = fn(ks.data_ptr(), vs.data_ptr(), view.k.data_ptr(),
             view.v.data_ptr(),
             view.k_scale.data_ptr() if quant else None,
             view.v_scale.data_ptr() if quant else None, blk.data_ptr(),
             None if off is None else off.data_ptr(),
             sk[0], sk[1], sk[2], sk[3], sv[0], sv[1], sv[2], sv[3],
             rows, r2, lc, kvh, dh, div, bt, nb, nl, int(l0),
             _build.DTYPE_CODES[ks.dtype], _build.POOL_CODES[view.k.dtype],
             _build.stream_ptr(ks))
    _build.check(err, "kv_write_v1")
    kv_write_v1.launches += 1
    return view


kv_write_v1.launches = 0  # kernel launches (CUDA path only)


def paged_append(view: KVPoolView, k, v, l: int, page: PageRef) -> KVPoolView:
    """Write one token's K/V per slot — k/v (S, KVH, Dh) — at
    (page.blk, page.off, l), in place.  Invalid slots point at scratch."""
    return kv_write(view, k[None, :, None], v[None, :, None], page.blk,
                    page.off, l)


def paged_panel(view: KVPoolView, l: int, page: PageRef, out_dtype=None):
    """Gather layer l's K/V panels through the block tables:
    (S, KVH, W * block_tokens, Dh) per side.  Unquantized panels stay in
    the pool's resting dtype; quantized panels dequantize (f32 code x
    scale) to `out_dtype` (JAX pool.py:130-150)."""
    tables = page.tables.long()
    mode = quant_mode(view)

    def panel(pool, scale):
        g = _raw(pool)[:, :, l][tables].view(pool.dtype)  # (S, W, bt, KVH, Dh)
        s, w, bt, kvh, dh = g.shape
        g = g.reshape(s, w * bt, kvh, dh).transpose(1, 2)
        if mode is None:
            return g
        sg = scale[:, :, l][tables].reshape(s, w * bt, kvh).transpose(1, 2)
        return (g.float() * sg[..., None]).to(out_dtype)

    return panel(view.k, view.k_scale), panel(view.v, view.v_scale)


def paged_append_span(view: KVPoolView, ks, vs, tables, pos0, count,
                      block_tokens: int) -> KVPoolView:
    """Commit a verified SPAN of K/V per slot, in place (JAX
    pool.py:153-197).  ks/vs (L, S, KVH, K1, Dh): span offset j is the
    token at position pos0[s] + j; tables (S, W); count (S,) in [0, K1]
    — how many leading offsets commit.  Offsets >= count (rejected
    drafts, inactive slots, positions past the request's K/V horizon)
    land on (SCRATCH_BLOCK, 0); one `kv_write` covers both sides and all
    layers."""
    K1 = ks.shape[3]
    j = torch.arange(K1, device=ks.device)[None, :]
    wpos = pos0.long()[:, None] + j  # (S, K1) absolute write positions
    valid = j < count.long()[:, None]
    W = tables.shape[1]
    # clamp the table lookup BEFORE masking: an invalid offset's position
    # may lie past the table (torch raises where JAX would clamp)
    bidx = torch.clamp(torch.div(wpos, block_tokens, rounding_mode="floor"),
                       max=W - 1)
    blk = torch.gather(tables.long(), 1, bidx)
    blk = torch.where(valid, blk, SCRATCH_BLOCK)
    off = torch.where(valid, wpos % block_tokens, 0)
    # row s * K1 + j of every layer: (L, S, K1, KVH, Dh) views
    return kv_write(view, ks.transpose(2, 3), vs.transpose(2, 3),
                    blk.reshape(-1), off.reshape(-1), 0)


def paged_scatter(view: KVPoolView, ks, vs, block_ids,
                  block_tokens: int) -> KVPoolView:
    """Scatter a prefill's K/V into the pool blocks `block_ids`
    ((P / block_tokens,) physical ids; padding-tail entries point at
    scratch), in place.  ks/vs: (L, 1, KVH, P, Dh) stacks, or sequences
    of L (1, KVH, P, Dh) tensors — each layer's own K/V (the model's
    strided views of its qkv product), read where they lie."""
    one = ks if isinstance(ks, torch.Tensor) else ks[0][None]
    require(one.shape[1] == 1 and one.shape[3] % block_tokens == 0
            and block_tokens == view.k.shape[1],
            lambda: f"paged_scatter: one request of whole "
            f"{view.k.shape[1]}-token blocks, got {tuple(one.shape)} at "
            f"block_tokens {block_tokens}")

    def rows(xs):  # prompt position p of every layer: (1, P, KVH, Dh)
        if isinstance(xs, torch.Tensor):
            return xs.transpose(2, 3)
        return [x.transpose(1, 2) for x in xs]

    return kv_write(view, rows(ks), rows(vs), block_ids.long(), None, 0)


class PagedKVPool:
    """Host-side pool owner: the device tensors plus exact, refcounted
    block accounting (JAX pool.py:313-440).  `num_blocks` is the USABLE
    count; one scratch block is allocated on top and never handed out.
    `alloc` hands blocks out at refcount 1 in ascending order from a LIFO
    free list, `share` adds a holder (a prefix-cache alias or the radix
    tree itself), `free_blocks` drops one and returns a block to the free
    list when its last holder lets go.  `quant` rests the blocks at int8
    or e4m3 with separate f32 scale tensors per side."""

    def __init__(self, *, n_layer: int, kv_heads: int, head_dim: int,
                 num_blocks: int, block_tokens: int, dtype,
                 quant: Optional[str] = None,
                 device: Union[None, str, torch.device] = None):
        if quant not in KV_QUANT_MODES:
            raise ValueError(f"KV-cache quant must be one of "
                             f"{KV_QUANT_MODES}, got {quant!r}")
        if num_blocks < 1 or block_tokens < 1:
            raise ValueError("num_blocks and block_tokens must be >= 1")
        self.device = resolve_device(device)
        self.num_usable = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.quant = quant
        total = self.num_usable + 1  # + scratch
        shape = (total, block_tokens, n_layer, kv_heads, head_dim)
        rest = QDTYPE.get(quant, dtype)

        def scale():
            return (torch.zeros(shape[:-1], dtype=torch.float32,
                                device=self.device) if quant else None)

        self.view = KVPoolView(
            k=torch.zeros(shape, dtype=rest, device=self.device),
            v=torch.zeros(shape, dtype=rest, device=self.device),
            k_scale=scale(), v_scale=scale())
        # pop() hands out ascending ids from 1; frees push back LIFO
        self._free: List[int] = list(range(total - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """DISTINCT allocated blocks."""
        return self.num_usable - len(self._free)

    def refcount(self, b: int) -> int:
        """Holder count of block `b` (0 = free)."""
        return self._ref.get(int(b), 0)

    def ref_counts(self) -> Dict[int, int]:
        return dict(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n block ids at refcount 1, or None WITHOUT allocating when fewer
        than n are free (admission is all-or-nothing)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        return ids

    def share(self, ids: List[int]) -> None:
        """Add one holder to each allocated block in `ids`."""
        for b in ids:
            if self._ref.get(b, 0) < 1:
                raise ValueError(
                    f"cannot share block {b}: not allocated (a free "
                    "block's contents are reusable garbage)")
        for b in ids:
            self._ref[b] += 1

    def free_blocks(self, ids: List[int]) -> None:
        """Drop one holder per id; a block whose last holder lets go
        returns to the free list (LIFO, in `ids` order)."""
        drops = Counter(int(b) for b in ids)
        for b, n in drops.items():
            if not 1 <= b <= self.num_usable:
                raise ValueError(f"freeing invalid block id {b}")
            if self._ref.get(b, 0) < n:
                raise ValueError(
                    f"double free of block {b}: {n} release(s) against "
                    f"refcount {self._ref.get(b, 0)}")
        for b in ids:
            b = int(b)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)

    def kv_bytes(self) -> dict:
        """The pool's resting device footprint, from the tensors' own
        dtypes and shapes: K+V block bytes, scale bytes, the element
        width (dtype names spelled as the JAX package spells them)."""
        k = self.view.k
        blocks = 2 * k.numel() * k.element_size()
        ks = self.view.k_scale
        scales = 2 * ks.numel() * ks.element_size() if ks is not None else 0
        return {"kv_block_bytes": int(blocks), "scale_bytes": int(scales),
                "total_bytes": int(blocks + scales),
                "dtype": str(k.dtype).replace("torch.", ""),
                "itemsize": int(k.element_size())}
