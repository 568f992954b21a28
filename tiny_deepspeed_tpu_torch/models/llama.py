# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The Llama family in PyTorch: RMSNorm, RoPE, SwiGLU, grouped K/V.

Counterpart of `tiny_deepspeed_tpu/models/llama.py`: same configuration
(`LlamaConfig`, `LLAMA_PRESETS`), same parameter names, layouts and
insertion order, the same block.  `LlamaModel` is a `GPT2Model` with its
hooks overridden, so training (every engine, remat, the loss heads, the
fp8 gather) and serving (prefill, the paged decode with its append, the
verify span, the prefix cache, quantized pools) run the GPT-2 machinery:

- the norms (`_norm` / `_add_norm`) are RMSNorm (ops/rmsnorm.py: the
  LayerNorm CUDA entries under their RMS flag on the card), with no
  biases anywhere;
- the attention half (`_attn`) makes separate q/k/v products, rotates q
  and k (RoPE, f32 angles, the rotation in f32, cast back), and hands
  `sharded_attention` K/V at `kv_heads`: the FA2 kernels and ring
  attention take them grouped.  `return_kv` returns the post-RoPE K/V
  unrepeated (JAX :209-248), so the pool rests at `kv_heads`;
- the MLP (`_mlp`) is SwiGLU: down(silu(gate(h)) * up(h));
- positions enter through RoPE only (no wpe).  Under a sequence split
  the rank's positions start at seq_rank * Tl: the port splits T by
  hand on each rank (JAX's `_positions`, :201-207, offsets only under
  seq x pipe, because under GSPMD its arrays are global).

Tensor parallelism (JAX `tp_rules`, :178-190): q / k / v / gate / up
column-parallel, o / down row-parallel (`_row`, no biases), lm_head
vocab-parallel, as GPT-2's.  A model rank runs H/tp query heads and
KVH/tp K/V heads, so the group ratio stays; RoPE's positions do not
change.  The port cuts whole K/V heads: a kv-head count the model axis
does not divide is refused (`parallel.tensor.TPLayout`), where JAX
shards k.w's columns whenever they divide.

RoPE and SwiGLU stay plain PyTorch, as they are plain `jnp` in JAX.  The
serving decode computes the rotation's cos/sin once a tick from the
slots' positions and reuses them across the layers (`paged_decode`), and
rotates q and k in one pass; the verify span does the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.collectives import copy_to
from ..ops.linear import linear
from ..ops.rmsnorm import add_rmsnorm, rmsnorm
from . import gpt2
from .gpt2 import GPT2Model, GPTConfig, Params, _model_comm


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class LlamaConfig(GPTConfig):
    """GPTConfig's fields (the inherited `bias` is ignored: the family is
    bias-free) plus the Llama knobs (JAX :45-64)."""

    n_kv_head: Optional[int] = None     # None -> n_head (MHA)
    rope_theta: float = 10000.0
    ffn_hidden: Optional[int] = None    # None -> round_up(8/3 * d, 128)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def ffn(self) -> int:
        return self.ffn_hidden or _round_up(int(8 * self.n_embd / 3), 128)


LLAMA_PRESETS: Dict[str, LlamaConfig] = {
    "llama-tiny": LlamaConfig(block_size=256, vocab_size=512, n_layer=2,
                              n_head=4, n_kv_head=2, n_embd=64,
                              compute_dtype=torch.float32),
    "llama-160m": LlamaConfig(block_size=1024, vocab_size=50304, n_layer=12,
                              n_head=12, n_kv_head=4, n_embd=768),
    "llama-1b": LlamaConfig(block_size=2048, vocab_size=50304, n_layer=22,
                            n_head=32, n_kv_head=8, n_embd=2048),
}


# -- RoPE ---------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, dh: int, theta: float):
    """The rotation at `positions` (any shape P): (cos2, sin2), each
    (*P, Dh) f32 — cos of the angles twice over, and (-sin, sin) — so
    that `rope_apply` is one multiply-add pair over the whole head
    vector.  Angles as JAX computes them (:80-86): f32 frequencies
    theta ** (-i / half), times the f32 position.  XLA's f32 `pow` is
    correctly rounded and torch's is not (an ulp apart on a few
    exponents, which a position of 2000 turns into 1e-4 of the angle):
    the power is taken in f64 and rounded once, XLA's bits.  cos and
    sin of the f32 angles come from `_cos_sin_f64`, rounded once."""
    half = dh // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = (theta ** expo.to(torch.float64)).to(torch.float32)
    ang = positions.to(torch.float32)[..., None] * freqs
    cos, sin = _cos_sin_f64(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


# pi/2 as fdlibm splits it: 33 leading bits (k * _PIO2_HI is exact for
# k < 2**20) and the rest
_PIO2_HI = 1.57079632673412561417e+00
_PIO2_LO = 6.07710050650619224932e-11


def _cos_sin_f64(ang: torch.Tensor):
    """(cos, sin) of f32 angles, each computed in f64 and rounded to f32
    once.  The quadrant reduction is done here, in f64, so that the
    library's cos / sin only ever see |r| <= pi/4: torch's CPU f32
    cos / sin at arguments in the thousands came back up to 1.5e-4 off
    in some processes, differently from call to call, and a table must
    not change between calls."""
    a = ang.to(torch.float64)
    k = torch.round(a * (2.0 / math.pi))
    r = (a - k * _PIO2_HI) - k * _PIO2_LO
    c, s = torch.cos(r), torch.sin(r)
    q = torch.remainder(k, 4.0)
    # cos(r + q pi/2), sin(r + q pi/2) for q = 0, 1, 2, 3
    cos = torch.where(q == 0, c, torch.where(
        q == 1, -s, torch.where(q == 2, -c, s)))
    sin = torch.where(q == 0, s, torch.where(
        q == 1, c, torch.where(q == 2, -s, -c)))
    return cos.to(torch.float32), sin.to(torch.float32)


def rope_apply(x, cos2, sin2):
    """x (..., Dh) rotated by tables that broadcast against it: in f32,
    [x1*cos - x2*sin, x2*cos + x1*sin], cast back to x's dtype.  Adding
    x2 * (-sin) is subtracting x2 * sin: the bits of JAX's formula."""
    xf = x.to(torch.float32)
    return (xf * cos2 + xf.roll(x.shape[-1] // 2, dims=-1) * sin2).to(
        x.dtype)


def rope(x, positions, theta: float):
    """Rotary position embedding on (B, H, T, Dh); positions (T,) ints."""
    return rope_apply(x, *rope_tables(positions, x.shape[-1], theta))


def rope_span(x, positions, theta: float):
    """RoPE for a draft-span batch: x (S, H, K1, Dh), positions (S, K1) —
    row s's span position j rotated at positions[s, j] (the speculative
    verify; JAX :105-124)."""
    cos2, sin2 = rope_tables(positions, x.shape[-1], theta)
    return rope_apply(x, cos2[:, None], sin2[:, None])


def rope_at(x, positions, theta: float):
    """RoPE for one token a row: x (B, H, 1, Dh), positions (B,) — each
    row rotated at its own position (the paged decode).  The
    one-position case of `rope_span`, as in JAX (:89-102)."""
    return rope_span(x, positions[:, None], theta)


# -- the model ----------------------------------------------------------------

class LlamaModel(GPT2Model):
    """Llama on `device` (the card unless the caller passes device="cpu"):
    GPT2Model's contract — init / apply / serving — over Llama's block."""

    def __init__(self, config: LlamaConfig, device=None):
        if config.n_head % config.kv_heads:
            raise ValueError(f"n_head {config.n_head} must be a multiple of "
                             f"n_kv_head {config.kv_heads}")
        super().__init__(config, device=device)

    # -- parameters ---------------------------------------------------------

    def param_shapes(self) -> Dict[str, tuple]:
        """{name: shape} in the JAX package's insertion order (:147-160)."""
        c = self.config
        d, l, v, f = c.n_embd, c.n_layer, c.vocab_size, c.ffn
        kvd = c.kv_heads * c.head_dim
        shapes = {
            "wte": (v, d),
            "h.ln_1.w": (l, d),
            "h.attn.q.w": (l, d, d), "h.attn.k.w": (l, d, kvd),
            "h.attn.v.w": (l, d, kvd), "h.attn.o.w": (l, d, d),
            "h.ln_2.w": (l, d),
            "h.mlp.gate.w": (l, d, f), "h.mlp.up.w": (l, d, f),
            "h.mlp.down.w": (l, f, d),
            "ln_f.w": (d,),
            "lm_head.w": (d, v),
        }
        if c.tie_weights:
            del shapes["lm_head.w"]
        return shapes

    def tp_rules(self) -> Dict[str, int]:
        """Column-parallel q / k / v / gate / up, row-parallel o / down,
        vocab-parallel lm_head (JAX :178-190)."""
        return {"h.attn.q.w": 2, "h.attn.k.w": 2, "h.attn.v.w": 2,
                "h.attn.o.w": 1, "h.mlp.gate.w": 2, "h.mlp.up.w": 2,
                "h.mlp.down.w": 1, "lm_head.w": 1}

    def tp_blocks(self) -> Dict[str, int]:
        """None: q, k and v are leaves of their own."""
        return {}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LlamaModel":
        """Llama init from `generator` (JAX :135-161): N(0, 0.02), the
        residual projections (attn.o, mlp.down) N(0, 0.02/sqrt(2L)), norm
        weights 1.  Draws on the generator's device, then moves to the
        model's."""
        c = self.config
        std = 0.02
        pstd = std / math.sqrt(2 * c.n_layer)
        gdev = generator.device
        for name, p in self.named_parameters():
            if name.endswith(("ln_1.w", "ln_2.w")) or name == "ln_f.w":
                p.fill_(1.0)
            else:
                s = pstd if name.endswith(("attn.o.w", "mlp.down.w")) else std
                r = torch.randn(p.shape, generator=generator, device=gdev,
                                dtype=torch.float32) * s
                p.copy_(r.to(p.dtype))
        return self

    # -- the block's hooks ----------------------------------------------------

    def embed(self, idx: torch.Tensor, pctx=None,
              params: Optional[Params] = None) -> torch.Tensor:
        """Token embedding only: positions enter through RoPE."""
        if pctx is not None and (idx.shape[1] * pctx.seq_size
                                 > self.config.block_size):
            raise ValueError(f"sequence length {idx.shape[1] * pctx.seq_size}"
                             f" > block_size {self.config.block_size}")
        return self.embed_tokens(idx, params)

    def _norm(self, x, p: Params, name: str):
        return rmsnorm(x, p[name + ".w"])

    def _add_norm(self, x, r, p: Params, name: str):
        return add_rmsnorm(x, r, p[name + ".w"])

    def _qkv(self, h, bp: Params, tp=None):
        """The separate q, k, v products of h (..., T, D), as (..., H, T,
        Dh) and (..., KVH, T, Dh) head tensors (views); under the model
        group `tp` the rank's H/tp and KVH/tp heads."""
        c = self.config
        *lead, t, _ = h.shape
        n = 1 if tp is None else tp.size
        h = copy_to(h, tp)

        def heads(z, nh):
            return z.reshape(*lead, t, nh, c.head_dim).transpose(-3, -2)

        return (heads(linear(h, self._bw(bp, "attn.q.w"), None),
                      c.n_head // n),
                heads(linear(h, self._bw(bp, "attn.k.w"), None),
                      c.kv_heads // n),
                heads(linear(h, self._bw(bp, "attn.v.w"), None),
                      c.kv_heads // n))

    def _out(self, y, bp: Params, tp=None):
        """(..., H, T, Dh) attention output -> its projection (..., T, D)
        (row-parallel under the model group `tp`)."""
        y = y.transpose(-3, -2)
        return self._row(y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1]),
                         bp, "attn.o", tp)

    def _attn(self, h, bp: Params, pctx=None):
        c = self.config
        t = h.shape[1]
        tp = _model_comm(pctx)
        q, k, v = self._qkv(h, bp, tp)
        off = 0 if pctx is None else pctx.seq_rank * t
        pos = torch.arange(off, off + t, device=h.device)
        cos2, sin2 = rope_tables(pos, c.head_dim, c.rope_theta)
        q, k = rope_apply(q, cos2, sin2), rope_apply(k, cos2, sin2)
        # K/V enter at kv_heads: FA2 and the ring take them grouped
        y = gpt2.sharded_attention(q, k, v, c.attn_impl, pctx)
        return self._out(y, bp, tp), (k, v)

    def _mlp(self, h, bp: Params, pctx=None):
        """SwiGLU on ln_2's output h: gate / up column-parallel and down
        row-parallel under tensor parallelism."""
        tp = _model_comm(pctx)
        h = copy_to(h, tp)
        gate = F.silu(linear(h, self._bw(bp, "mlp.gate.w"), None))
        up = linear(h, self._bw(bp, "mlp.up.w"), None)
        return self._row(gate * up, bp, "mlp.down", tp)

    # -- serving --------------------------------------------------------------

    def _embed_decode(self, tok: torch.Tensor, pos: torch.Tensor):
        """No wpe table: the position enters through RoPE in each block."""
        return self.embed_tokens(tok[:, None])

    def _embed_decode_span(self, toks: torch.Tensor, positions):
        return self.embed_tokens(toks)

    def _rot(self, positions):
        """The tick's rotation tables at (S, K1) positions, shaped to
        broadcast over (S, H, K1, Dh)."""
        cos2, sin2 = rope_tables(positions, self.config.head_dim,
                                 self.config.rope_theta)
        return cos2[:, None], sin2[:, None]

    def _rope_qk(self, q, k, rot):
        """q and k rotated in one pass (their heads side by side)."""
        qk = rope_apply(torch.cat([q, k], dim=1), *rot)
        return qk[:, :self.config.n_head], qk[:, self.config.n_head:]

    def _paged_attn_decode(self, h, bp: Params, view, l: int, page, rot):
        """Attention half of one paged decode step (GPT2Model's contract,
        plus `rot`, the tick's RoPE tables at each slot's own position):
        the rotated K/V are written by the decode launch itself
        (`append_kv`)."""
        q, k, v = self._qkv(h, bp)
        q, k = self._rope_qk(q, k, rot)
        y = self._paged_attention(q, view, l, page,
                                  append_kv=(k[:, :, 0], v[:, :, 0]))
        return self._out(y, bp)

    @torch.no_grad()
    def paged_decode(self, stacked: Params, x, view, page):
        rot = self._rot(page.pos[:, None])
        x, _ = self._serve_layers(stacked, x, lambda h, bp, l: (
            self._paged_attn_decode(h, bp, view, l, page, rot), None))
        return x, view

    def _paged_verify_attn(self, h, bp: Params, view, l: int, page, rot):
        """Attention half of one verify step, `rot` the RoPE tables at each
        span token's absolute position page.pos + j; the span's rotated
        K/V come back for the commit."""
        q, k, v = self._qkv(h, bp)
        q, k = self._rope_qk(q, k, rot)
        y = self._paged_attention(q, view, l, page, span_kv=(k, v))
        return self._out(y, bp), (k, v)

    @torch.no_grad()
    def paged_verify(self, stacked: Params, x, view, page):
        rot = self._rot(page.pos[:, None] + torch.arange(
            x.shape[1], device=page.pos.device))
        x, kv = self._serve_layers(stacked, x, lambda h, bp, l: (
            self._paged_verify_attn(h, bp, view, l, page, rot)))
        return (x, torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))
