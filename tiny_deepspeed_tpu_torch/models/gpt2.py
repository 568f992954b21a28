# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""GPT-2 in PyTorch: the training forward with its loss, and serving.

Counterpart of `tiny_deepspeed_tpu/models/gpt2.py`: same configuration,
same parameter names and layouts (a flat dotted name space with the L
transformer blocks STACKED on a leading axis, linear weights (in, out)),
same pre-LN block, f32 master parameters and a compute dtype (bf16 on
gpt2-124m).  Parameters are registered on nested submodules so
`named_parameters()` yields exactly the JAX package's flat dict keys, and
`load_state_dict(params_from_numpy(...))` takes the JAX package's weights.

Training: `apply(idx, targets)` returns the mean cross-entropy loss and
is differentiable (parameters require grad); each block runs under the
configured remat policy (`torch.utils.checkpoint`, see `_block_fn`).
The loss head is one of three (`effective_xent_impl`): the materialized
logits (default), the chunked `fused_linear_xent` or the fused-kernel
`pallas_fused_xent` (`GPTConfig(fused_xent=True, fused_xent_impl=...)`).
Dropout (`GPTConfig.dropout`) applies when `apply` is given an integer
`rng` key, at the JAX package's three sites with its key tree, through
`ops.dropout` (a Triton kernel on the card).  Its masks are
counter-based: an element's bit is a function of the site's key and the
element's index in the global (B, T, C) tensor, so they are the same on
any number of ranks.

Under the distributed engines `apply` takes the rank's
`parallel.mesh.ParallelContext` (`pctx`).  With the sequence split over
a seq group, the rank holds positions [s*Tl, (s+1)*Tl): it adds those
rows of `wpe` (JAX slices the global `wpe[:T]` and shards it, :819-824),
attention runs as ring attention or Ulysses (`pctx.seq_impl`,
`ops.attention.sharded_attention`) and the loss is the mean over the
rank's own tokens (the engine averages it).  The sequence-parallel
autograd Functions sit inside each block's `torch.utils.checkpoint`, so
the backward's recompute re-runs their forward collectives.  That is
correct: every rank of the group recomputes the same layers in the same
order, so the collectives pair up as they did in the forward.  Dropout
draws each rank's block of the global mask (`_dropout_frame`).

Serving: the `return_kv` prefill hook, the paged decode step, the
speculative verify span (`paged_verify`, `head_span`; also the prefix
cache's suffix prefill) and the inference head, all without a graph.

Sampling: `generate` (JAX :1204-1280), cached or not.  The cached path
keeps JAX's dense cache in the paged pool's layout — a private
`PagedKVPool` in which row b owns one fixed run of blocks (`GenCache`) —
so its prompt pass is one batched block pass plus one `kv_write`, and
each token one paged decode step, the serving tier's decode kernel with
its append (9a) on the card, every row at the same position.

`GPTConfig(gather_quant="fp8")` (JAX :84-104, :826-900): the block
matmul weights stack once per step as float8_e4m3 codes plus a
per-(layer, out-channel) f32 scale, and every path that reads a block
weight dequantizes it through `_bw` — training, prefill, decode and
verify alike.  Under ZeRO-3 the per-layer gathers then move the 1-byte
codes (parallel/zero3.py); on one device it is the same arithmetic.

Under ZeRO-3 (`pctx.gather` set, parallel/zero3.py) `apply` takes the
rank's shards as `params`: the engine's gather returns the non-block
leaves whole and the block leaves stacked at rest, and each block
gathers its own layer's weights inside its checkpoint, so the backward's
recompute gathers them again.

The schedule seam (JAX `apply(..., sched=)`, :982-1016): `apply(...,
sched=executor)` hands the step's stacking of the block weights to
`sched.prepare` and the layer loop to `sched.blocks`
(parallel/schedule.py: the bucketed gradient release, the prefetching
ZeRO-3 gather, the composed schedule).  With no executor the program is
the one above.  `grad_bucket_capable` / `gather_prefetch_capable` say a
family's loop may be handed over (JAX :255-257).
"""

from __future__ import annotations

import dataclasses
import math
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from .. import rng as prng
from ..ops.attention import ATTENTION, sharded_attention
from ..ops.dispatch import resolve_device
from ..ops.dropout import dropout, dropout_keep
from ..ops.embedding import embedding, renorm_weight
from ..ops.fused_xent import pallas_fused_xent
from ..ops.layernorm import add_layernorm, layernorm
from ..ops.linear import linear
from ..ops.paged_attn import decode_attention, paged_attention
from ..ops.softmax_xent import fused_linear_xent, softmax_cross_entropy
from .sampling import sample_logits


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model hyperparameters (JAX models/gpt2.py:53), with the JAX
    defaults (`remat=True`, `remat_policy="dots_no_batch"`)."""

    block_size: int = 1024
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    attn_impl: str = "flash_attention"  # or "standard_attention"
    bias: bool = True
    dropout: float = 0.0
    tie_weights: bool = False
    gather_quant: Optional[str] = None
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    # "nothing" | "dots" | "dots_no_batch" | "all" (see GPT2Model._block_fn)
    remat_policy: str = "dots_no_batch"
    wte_max_norm: Optional[float] = None
    # fused lm_head + loss, never materializing the (B, T, V) logits:
    # "chunked" (ops/softmax_xent.fused_linear_xent) or "pallas" (the
    # fused kernels of ops/fused_xent.py)
    fused_xent: bool = False
    fused_xent_impl: str = "chunked"
    cache_dtype: Any = None

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


_CACHE_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "fp16": torch.float16, "float16": torch.float16,
    "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32,
}


def resolved_cache_dtype(cfg) -> Any:
    """The KV cache's resting dtype: config.cache_dtype (string spelling
    or torch dtype), defaulting to compute_dtype."""
    cd = getattr(cfg, "cache_dtype", None)
    if cd is None:
        return cfg.compute_dtype
    if isinstance(cd, str):
        try:
            return _CACHE_DTYPES[cd]
        except KeyError:
            raise ValueError(
                f"cache_dtype {cd!r} not understood; use one of "
                f"{sorted(_CACHE_DTYPES)} or a torch dtype") from None
    return cd


GPT2_PRESETS: Dict[str, GPTConfig] = {
    "tiny": GPTConfig(block_size=256, vocab_size=512, n_layer=2, n_head=2,
                      n_embd=64, compute_dtype=torch.float32),
    "gpt2-124m": GPTConfig(n_layer=12, n_head=12, n_embd=768),
    "gpt2-350m": GPTConfig(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-774m": GPTConfig(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-1.5b": GPTConfig(n_layer=48, n_head=25, n_embd=1600),
}

Params = Dict[str, torch.Tensor]

_XENT_IMPLS = ("chunked", "pallas")
_GATHER_QUANTS = (None, "fp8")


def fp8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """The fp8 gather's f32 scale from a channel's f32 absmax: it maps the
    absmax onto e4m3's largest finite value, 448 (JAX :855-858)."""
    return absmax / 448.0 + 1e-12


def e4m3_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn as XLA converts (to nearest, ties to
    even; past the largest finite value, NaN: e4m3fn has no infinity, and
    |x| > 464 — halfway to the next step, 480 — rounds past it), returned
    in f32.  torch's cast saturates to +-448 there instead, so the NaN is
    put back by hand.  Casts only: the CPU has no float8 arithmetic."""
    r = x.to(torch.float8_e4m3fn).float()
    return torch.where(x.float().abs() > 464.0, float("nan"), r)


def fp8_cotangent(g: torch.Tensor, scale: torch.Tensor, cd) -> torch.Tensor:
    """The cotangent JAX's autodiff hands a quantized weight's f32 master
    for w = e4m3(master / scale) in cd times scale in cd (JAX :861, :900):
    the codes' cotangent g * scale in the compute dtype, rounded to e4m3
    (the "per-layer dW cotangent crosses the same edge in e4m3", JAX
    :92-95), then divided by the stop-gradiented scale in f32.  `scale`
    broadcasts against g."""
    return e4m3_round(g * scale.to(cd)) / scale


class Fp8WeightFn(torch.autograd.Function):
    """A block weight of the fp8 gather, on one device: codes (e4m3, the
    layer's slice of the stacked codes) times scale in the compute dtype.
    `master` (the layer's f32 master) is not read; it takes the gradient,
    `fp8_cotangent`, which autograd's default for `.to()` would not give
    (it would round to e4m3 by saturating, and move f8 tensors through
    ops the CPU does not have)."""

    @staticmethod
    def forward(ctx, master, codes, scale, cd):
        ctx.save_for_backward(scale)
        ctx.cd = cd
        return codes.to(cd) * scale.to(cd)

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        return fp8_cotangent(g, scale, ctx.cd), None, None, None


def effective_xent_impl(cfg, multi_device: bool = False,
                        seq_sharded: bool = False) -> str:
    """The loss head a step with this config runs (JAX :205-225):
    "unfused" (materialized logits), "chunked" or "pallas".  As in JAX,
    a sequence split over ranks (`seq_sharded`) runs the unfused head and
    more than one rank (`multi_device`) turns "pallas" into "chunked".
    The JAX predicate also sends "pallas" to the chunked path off a TPU
    and for a token count with no VMEM-sized token block; the port's
    kernels take any token count, so it has neither.  `GPT2Model` refuses
    any other `fused_xent_impl`."""
    if not cfg.fused_xent or seq_sharded:
        return "unfused"
    if cfg.fused_xent_impl == "pallas" and multi_device:
        return "chunked"
    return cfg.fused_xent_impl


def _dropout_keep(key: int, shape, keep: float, device,
                  frame=None) -> torch.Tensor:
    """Bernoulli(keep) mask of the block at `frame` = (global shape,
    this block's offsets) — default the whole tensor — drawn
    counter-based from `key` (ops/dropout.dropout_keep): an element's bit
    depends on the key and its global index only, so a remat recompute
    redraws it exactly and every rank layout draws the same global mask.
    The one place the CPU route draws a mask; the kernel on the card
    computes the same bits."""
    return dropout_keep(key, shape, keep, device, frame)


def _dropout_frame(shape, pctx):
    """(global shape, offsets) of this rank's (B, T, ...) block under
    `pctx`: rows [d*B, (d+1)*B) of the global batch, tokens [s*T,
    (s+1)*T) of the global sequence; None (the tensor itself) on one
    rank."""
    if pctx is None or not pctx.is_multi_device:
        return None
    b, t, *rest = shape
    return ((b * pctx.data_size, t * pctx.seq_size, *rest),
            (pctx.data_rank * b, pctx.seq_rank * t) + (0,) * len(rest))


def _dropout(x, key: int, rate: float, pctx=None):
    """Inverted dropout (JAX :228-234): zero with probability `rate`,
    survivors scaled 1/(1-rate), through `ops.dropout.dropout` (the
    Triton kernel on the card) with the mask of x's place in the global
    (B, T, C) tensor under `pctx`."""
    return dropout(x, key, rate, _dropout_frame(x.shape, pctx),
                   mask_fn=_dropout_keep)


# remat policy -> the aten products whose outputs the checkpoint keeps
# (None: recompute the whole block); "all" takes no checkpoint at all
_REMAT_SAVE = {
    "nothing": None,
    "dots_no_batch": (torch.ops.aten.mm.default,),
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
    "all": None,
}


def _save_policy(ops):
    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


class GPT2Model(nn.Module):
    """GPT-2 with its parameters on `device` (the card unless the caller
    passes device="cpu"; without CUDA and without a device it raises)."""

    # the serving engine's paged decode batches slots at mixed positions
    paged_decode_capable = True
    # apply() hands its layer loop to the schedule's executor (sched=):
    # the bucketed grad-release tap and the scheduled weight gathers
    grad_bucket_capable = True
    gather_prefetch_capable = True

    def __init__(self, config: GPTConfig,
                 device: Union[None, str, torch.device] = None):
        super().__init__()
        if config.gather_quant not in _GATHER_QUANTS:
            raise ValueError(f"gather_quant {config.gather_quant!r} not in "
                             f"{_GATHER_QUANTS}")
        if config.fused_xent_impl not in _XENT_IMPLS:
            raise ValueError(f"fused_xent_impl {config.fused_xent_impl!r} "
                             f"not in {_XENT_IMPLS}")
        if not 0.0 <= config.dropout < 1.0:
            raise ValueError(f"dropout {config.dropout} not in [0, 1)")
        if config.remat_policy not in _REMAT_SAVE:
            raise ValueError(f"remat_policy {config.remat_policy!r} not in "
                             f"{sorted(_REMAT_SAVE)}")
        if config.attn_impl not in ATTENTION:
            raise ValueError(f"attn_impl {config.attn_impl!r} not in "
                             f"{sorted(ATTENTION)}")
        if config.n_embd % config.n_head:
            raise ValueError("n_embd must be a multiple of n_head")
        self.config = config
        self.device = resolve_device(device)
        for name, shape in self.param_shapes().items():
            *path, leaf = name.split(".")
            mod: nn.Module = self
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, nn.Module())
                mod = getattr(mod, p)
            mod.register_parameter(leaf, nn.Parameter(
                torch.zeros(shape, dtype=config.param_dtype,
                            device=self.device)))

    # -- parameters ---------------------------------------------------------

    def param_shapes(self) -> Dict[str, tuple]:
        """{name: shape} in the JAX package's insertion order."""
        c = self.config
        d, l, v, t = c.n_embd, c.n_layer, c.vocab_size, c.block_size
        shapes = {
            "wte": (v, d), "wpe": (t, d),
            "h.ln_1.w": (l, d), "h.ln_1.b": (l, d),
            "h.attn.qkv.w": (l, d, 3 * d), "h.attn.qkv.b": (l, 3 * d),
            "h.attn.proj.w": (l, d, d), "h.attn.proj.b": (l, d),
            "h.ln_2.w": (l, d), "h.ln_2.b": (l, d),
            "h.mlp.fc.w": (l, d, 4 * d), "h.mlp.fc.b": (l, 4 * d),
            "h.mlp.proj.w": (l, 4 * d, d), "h.mlp.proj.b": (l, d),
            "ln_f.w": (d,), "ln_f.b": (d,),
            "lm_head.w": (d, v),
        }
        if not c.bias:
            for name in ("h.attn.qkv.b", "h.attn.proj.b",
                         "h.mlp.fc.b", "h.mlp.proj.b"):
                del shapes[name]
        if c.tie_weights:
            del shapes["lm_head.w"]
        return shapes

    def param_dict(self) -> Params:
        """The flat {dotted name: tensor} view (JAX's params dict)."""
        return dict(self.named_parameters())

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "GPT2Model":
        """GPT-2 init from `generator`: N(0, 0.02), residual projections
        N(0, 0.02/sqrt(2L)), layernorm weights 1, biases 0.  Draws on the
        generator's device, then moves to the model's."""
        c = self.config
        std = 0.02
        pstd = std / math.sqrt(2 * c.n_layer)
        gdev = generator.device
        for name, p in self.named_parameters():
            if name.endswith(("ln_1.w", "ln_2.w")) or name == "ln_f.w":
                p.fill_(1.0)
            elif name.endswith(".b"):
                p.zero_()
            else:
                s = pstd if name.endswith("proj.w") else std
                r = torch.randn(p.shape, generator=generator, device=gdev,
                                dtype=torch.float32) * s
                p.copy_(r.to(p.dtype))
        return self

    def _quant_eligible(self, name: str, shape) -> bool:
        """Which stacked leaves the fp8 gather quantizes: the block matmul
        weights (ndim >= 3 rules out layernorm w/b and every bias)."""
        return (self.config.gather_quant == "fp8"
                and name.endswith(".w") and len(shape) >= 3)

    def stacked_compute_params(self, params: Optional[Params] = None
                               ) -> Params:
        """The "h.*" tensors, keys without the "h." prefix, cast to the
        compute dtype ONCE per step (the serving engine keeps the result:
        params are frozen while serving).  Layer l is `{k: v[l]}`.

        With gather_quant="fp8" each eligible weight becomes e4m3 codes
        under its name, its f32 scale (absmax over IN per layer and
        out-channel / 448 + 1e-12, stop-gradiented) under name + "#scale"
        as in JAX, and — the port's own key — its f32 master under
        name + "#master", which `_bw`'s Function hands the gradient."""
        p = self.param_dict() if params is None else params
        out = {}
        for k, v in p.items():
            if not k.startswith("h."):
                continue
            name = k[2:]
            if self._quant_eligible(name, v.shape):
                vd = v.detach().float()
                s = fp8_scale(vd.abs().amax(dim=tuple(range(1, v.dim() - 1)),
                                            keepdim=True))
                out[name] = (vd / s).to(torch.float8_e4m3fn)
                out[name + "#scale"] = s
                out[name + "#master"] = v
            else:
                out[name] = v.to(self._stacked_dtype(name))
        return out

    def _stacked_dtype(self, name: str):
        """The dtype a stacked block leaf that the fp8 gather leaves
        alone rests in for the step (`stacked_compute_params`, ZeRO-3's
        `prepare`): the compute dtype.  A family keeps a leaf wider by
        overriding it (MoE's router)."""
        return self.config.compute_dtype

    def _bw(self, bp: Params, name: str):
        """A block weight of this layer's dict, dequantized when the fp8
        gather stacked it as (codes, scale) (JAX :867-900)."""
        s = bp.get(name + "#scale")
        if s is None:
            return bp[name]
        return Fp8WeightFn.apply(bp[name + "#master"], bp[name], s,
                                 self.config.compute_dtype)

    def head_compute_params(self, params: Optional[Params] = None) -> Params:
        """The head's tensors (final norm + lm_head) in the compute dtype,
        cast once — the inference head reads them every decode step."""
        p = self.param_dict() if params is None else params
        cd = self.config.compute_dtype
        names = [n for n in self.param_shapes() if n.startswith("ln_f.")]
        names.append("wte" if self.config.tie_weights else "lm_head.w")
        return {n: p[n].to(cd) for n in names}

    @staticmethod
    def _layer(stacked: Params, l: int) -> Params:
        return {k: v[l] for k, v in stacked.items()}

    @staticmethod
    def _layers(stacked: Params) -> List[Params]:
        """Every layer's dict at once: one `unbind` per stacked tensor, so
        the backward stacks the L layer gradients once instead of
        scattering each into a zeros-filled stacked tensor."""
        cols = {k: v.unbind(0) for k, v in stacked.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[l] for k, c in cols.items()} for l in range(n)]

    # -- forward ------------------------------------------------------------

    def embed_tokens(self, idx: torch.Tensor,
                     params: Optional[Params] = None) -> torch.Tensor:
        """wte gather (+ optional row-norm cap) -> (B, T, D) compute dtype."""
        c = self.config
        if idx.shape[1] > c.block_size:
            raise ValueError(
                f"sequence length {idx.shape[1]} > block_size {c.block_size}")
        wte = self.get_parameter("wte") if params is None else params["wte"]
        tok = embedding(idx, wte)
        if c.wte_max_norm is not None:
            tok = renorm_weight(tok, c.wte_max_norm)
        return tok.to(c.compute_dtype)

    def embed(self, idx: torch.Tensor, pctx=None,
              params: Optional[Params] = None) -> torch.Tensor:
        """Token + position embedding -> (B, T, D) in compute dtype.  On
        seq rank s of a split sequence, idx holds positions [s*T, (s+1)*T)
        and takes those rows of wpe."""
        t = idx.shape[1]
        off = 0
        if pctx is not None:
            off = pctx.seq_rank * t
            if t * pctx.seq_size > self.config.block_size:
                raise ValueError(f"sequence length {t * pctx.seq_size} > "
                                 f"block_size {self.config.block_size}")
        tok = self.embed_tokens(idx, params)
        wpe = self.get_parameter("wpe") if params is None else params["wpe"]
        return tok + wpe[off:off + t].to(tok.dtype)[None]

    def _block(self, x, bp: Params, return_kv: bool = False,
               dkey: Optional[int] = None, pctx=None):
        """One pre-norm block.  x (B, T, D) compute dtype; bp this layer's
        compute-dtype params.  return_kv also returns this layer's (k, v)
        head tensors — the prefill hook.  dkey, this layer's dropout key,
        drops after the attention's output projection (site 0) and after
        the MLP (site 1), JAX :370-379.  pctx routes attention
        (`sharded_attention`); under ZeRO-3 its gather first fetches this
        layer's weights (bp holds the rank's shards).  The norms, the
        attention half and the MLP are the hooks `_norm` / `_add_norm`,
        `_attn` and `_mlp`, which a model family overrides."""
        c = self.config
        if pctx is not None and pctx.gather is not None:
            bp = pctx.gather.layer(bp)
        h = self._norm(x, bp, "ln_1")
        y, kv = self._attn(h, bp, pctx)
        if dkey is not None:
            y = _dropout(y, prng.fold_in(dkey, 0), c.dropout, pctx)
        # the attention residual and ln_2 in one launch.  ln_1 stays
        # unfused: its residual is the previous block's output, across
        # the checkpoint boundary (fusing it would make each checkpoint
        # keep x and h instead of their sum)
        x, h = self._add_norm(x, y, bp, "ln_2")
        h = self._mlp(h, bp)
        if dkey is not None:
            h = _dropout(h, prng.fold_in(dkey, 1), c.dropout, pctx)
        x = x + h
        return (x, kv) if return_kv else x

    def _norm(self, x, p: Params, name: str):
        """The norm `name` ("ln_1", "ln_2", "ln_f") of x with its
        compute-dtype weights in p: LayerNorm."""
        return layernorm(x, p[name + ".w"], p[name + ".b"])

    def _add_norm(self, x, r, p: Params, name: str):
        """(x + r, the norm `name` of it) in one call."""
        return add_layernorm(x, r, p[name + ".w"], p[name + ".b"])

    def _attn(self, h, bp: Params, pctx=None):
        """The attention half of a block on ln_1's output h (B, T, D):
        (the projected attention output, before its residual, and the
        layer's (k, v) head tensors)."""
        c = self.config
        b, t, d = h.shape
        qkv = linear(h, self._bw(bp, "attn.qkv.w"), bp.get("attn.qkv.b"))
        q, k, v = qkv.split(d, dim=-1)

        def heads(z):  # (B, T, D) -> (B, H, T, Dh)
            return z.reshape(b, t, c.n_head, c.head_dim).transpose(1, 2)

        kh, vh = heads(k), heads(v)
        y = sharded_attention(heads(q), kh, vh, c.attn_impl, pctx)
        y = y.transpose(1, 2).reshape(b, t, d)
        return (linear(y, self._bw(bp, "attn.proj.w"), bp.get("attn.proj.b")),
                (kh, vh))

    def _mlp(self, h, bp: Params):
        """The MLP on ln_2's output h."""
        h = linear(h, self._bw(bp, "mlp.fc.w"), bp.get("mlp.fc.b"))
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu(approximate=True)
        return linear(h, self._bw(bp, "mlp.proj.w"), bp.get("mlp.proj.b"))

    def final_norm(self, x, params: Optional[Params] = None):
        cd = self.config.compute_dtype
        p = self.param_dict() if params is None else params
        return self._norm(x, {n: p[n].to(cd) for n in ("ln_f.w", "ln_f.b")
                              if n in p}, "ln_f")

    def _lm_head_w(self, params: Optional[Params] = None):
        """(d, vocab) projection weight — wte.T when tied."""
        c = self.config
        p = self.param_dict() if params is None else params
        w = p["wte"].t() if c.tie_weights else p["lm_head.w"]
        return w.to(c.compute_dtype)

    def head(self, x, position: Optional[int] = None,
             params: Optional[Params] = None,
             targets: Optional[torch.Tensor] = None, pctx=None):
        """Final norm + lm_head.  With `targets` (B, T): the mean
        cross-entropy loss over every position (JAX `head`, :953-971 —
        logits in the compute dtype, the loss in f32).  Without: (B, 1, V)
        f32 logits at ONE position (default the last); the norm is per
        row, so selecting the row first gives the JAX head's values at a
        fraction of the rows.  pctx (training) picks the loss head as
        `effective_xent_impl` does."""
        if targets is not None:
            x = self.final_norm(x, params)
            w = self._lm_head_w(params)
            impl = effective_xent_impl(
                self.config,
                multi_device=pctx is not None and pctx.is_multi_device,
                seq_sharded=pctx is not None and pctx.seq_size > 1)
            if impl == "pallas":
                return pallas_fused_xent(x, w, targets)
            if impl == "chunked":
                return fused_linear_xent(x, w, targets)
            return softmax_cross_entropy(linear(x, w, None), targets)
        x = x[:, -1:] if position is None else x[:, position:position + 1]
        x = self.final_norm(x, params)
        return linear(x, self._lm_head_w(params), None).float()

    def _block_fn(self):
        """(x, bp) -> the block's output (x; MoE's blocks: (x, aux))
        under the configured remat policy (JAX
        `block_fn` / `remat_policy`, :893-928), as a non-reentrant
        `torch.utils.checkpoint` per block:

        - "nothing": keep only the block's input; the backward recomputes
          the whole block;
        - "dots" / "dots_no_batch": also keep the outputs of the matrix
          products, through selective checkpointing — "dots_no_batch"
          the 2-D products (`aten.mm`: every linear layer), "dots" the
          batched ones too (`aten.bmm`).  The kernels' autograd Functions
          (LayerNormFn, FA2Fn) are recomputed, as the JAX policies
          recompute them;
        - "all": no checkpoint, everything is kept.

        The policy changes memory and recompute time, never the numbers:
        a recomputed block runs the same deterministic kernels on the
        same inputs, and redraws the same dropout masks (each a function
        of its key and the global index)."""
        c = self.config
        if not c.remat or c.remat_policy == "all":
            return lambda x, bp, dkey=None, pctx=None: self._block(
                x, bp, dkey=dkey, pctx=pctx)
        save = _REMAT_SAVE[c.remat_policy]
        kw = {}
        if save:
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                _save_policy(save))

        def block(x, bp, dkey=None, pctx=None):
            if not torch.is_grad_enabled():
                return self._block(x, bp, dkey=dkey, pctx=pctx)
            # the block draws no numbers from the global RNG state (its
            # dropout masks are hashes of dkey), so no RNG state needs
            # restoring for the recompute
            return ckpt.checkpoint(self._block, x, bp, dkey=dkey, pctx=pctx,
                                   use_reentrant=False,
                                   preserve_rng_state=False, **kw)
        return block

    def apply(self, idx: torch.Tensor,
              targets: Optional[torch.Tensor] = None,
              position: Optional[int] = None, rng: Optional[int] = None,
              pctx=None, params: Optional[Params] = None, sched=None):
        """Full forward of (B, T) tokens.  With `targets` (B, T): the mean
        loss, differentiable (JAX `apply(params, idx, targets)`).
        Without: (B, 1, V) f32 logits at `position` (default the last),
        computed without a graph.  `rng` (an integer key, training only)
        turns on dropout when config.dropout > 0: the embedding's, then
        one key per layer (JAX `_dropout_setup`, :902-912).  `pctx`, the
        rank's ParallelContext (training only): (B, T) is then this rank's
        block of the global batch and the loss its own tokens' mean.
        `params` (training only; default the model's own): the flat dict
        the forward reads — under ZeRO-3 (`pctx.gather`) the rank's
        shards, which the gather turns into whole non-block leaves and
        per-layer block weights.  `sched` (training only): the schedule's
        executor, which stacks the block weights and runs the layer loop
        (parallel/schedule.py)."""
        if (pctx is not None or sched is not None) and targets is None:
            raise ValueError("apply(pctx=... / sched=...) is the training "
                             "forward: pass targets")
        c = self.config
        if targets is None:
            with torch.no_grad():
                x = self.embed(idx)
                x, _ = self._blocks(x, self.stacked_compute_params(),
                                    [None] * c.n_layer)
                return self.head(x, position)
        if params is None:
            params = self.param_dict()
        if sched is not None:
            params, stacked = sched.prepare(self, params)
        elif pctx is not None and pctx.gather is not None:
            params, stacked = pctx.gather.prepare(params)
        else:
            stacked = self.stacked_compute_params(params)
        x = self.embed(idx, pctx, params)
        dkeys = [None] * c.n_layer
        if rng is not None and c.dropout:
            keys = prng.split(rng, c.n_layer + 1)
            x = _dropout(x, keys[0], c.dropout, pctx)
            dkeys = keys[1:]
        x, extra = self._blocks(x, stacked, dkeys, pctx, sched)
        loss = self.head(x, params=params, targets=targets, pctx=pctx)
        return loss if extra is None else loss + extra

    def _blocks(self, x, stacked: Params, dkeys, pctx=None, sched=None):
        """The layer loop: x through every block under the remat policy,
        layer l with its dropout key dkeys[l] — or the schedule's
        executor's loop when `sched` is given.  Returns (x, a term the
        blocks add to the loss, or None: GPT-2's blocks add none)."""
        if sched is not None:
            return sched.blocks(self, x, stacked, dkeys, pctx)
        block = self._block_fn()
        for bp, dkey in zip(self._layers(stacked), dkeys):
            x = block(x, bp, dkey, pctx)
        return x, None

    # -- paged KV-cache decode (the serving tier) ---------------------------

    def _embed_decode(self, tok: torch.Tensor, pos: torch.Tensor):
        """One token per row at its own position -> (S, 1, D)."""
        x = self.embed_tokens(tok[:, None])
        wp = self.get_parameter("wpe")[pos.long()][:, None]
        return x + wp.to(x.dtype)

    def _embed_decode_span(self, toks: torch.Tensor, positions):
        """(S, K1) tokens at (S, K1) absolute positions -> (S, K1, D).
        The caller clamps the positions to block_size - 1 (JAX's gather
        clamps out-of-range rows; torch raises)."""
        x = self.embed_tokens(toks)
        wp = self.get_parameter("wpe")[positions.long()]
        return x + wp.to(x.dtype)

    def _decode_attention(self, q, ck, cv, pos):
        return decode_attention(q, ck, cv, pos)

    def _paged_attention(self, q, view, l: int, page, span_kv=None,
                         append_kv=None):
        """Pool-panel attention (JAX :585): the paged kernels on the card,
        the plain gather + `ops.paged_attn.decode_attention` or
        `span_attention` on the CPU.  span_kv = (sk, sv) switches to the
        span-verify mask; append_kv = (k, v) first writes the decode
        step's own K/V into the pool (JAX's `paged_append`), on the card
        inside the decode launch."""
        return paged_attention(q, view, page, l, span_kv=span_kv,
                               append_kv=append_kv)

    def _paged_attn_decode(self, h, bp: Params, view, l: int, page):
        """Attention half of one paged decode step on ln_1's output h
        (S, 1, D): the projected attention output, before its residual.
        The step's K/V are written at (page.blk, page.off, l) by the
        attention call itself, before it reads them."""
        c = self.config
        s = h.shape[0]
        qkv = linear(h, self._bw(bp, "attn.qkv.w"), bp.get("attn.qkv.b"))
        q, k, v = qkv.split(c.n_embd, dim=-1)

        def heads1(z):  # (S, 1, D) -> (S, H, 1, Dh)
            return z.reshape(s, 1, c.n_head, c.head_dim).transpose(1, 2)

        y = self._paged_attention(
            heads1(q), view, l, page,
            append_kv=(heads1(k)[:, :, 0], heads1(v)[:, :, 0]))
        y = y.transpose(1, 2).reshape(s, 1, c.n_embd)
        return linear(y, self._bw(bp, "attn.proj.w"), bp.get("attn.proj.b"))

    def _serve_layers(self, stacked: Params, x, attn):
        """The serving layer loop: `attn(h, bp, l)` on ln_1's output gives
        layer l's attention output (and anything to collect).  Each
        residual add is fused into the norm after it — the attention's
        into ln_2, the MLP's into the next layer's ln_1 — so only the
        first ln_1 (reading the embedding) and the last MLP add (before
        `head`'s final norm) stay apart.  Returns (x, collected)."""
        pending, got = None, []
        for l in range(self.config.n_layer):
            bp = self._layer(stacked, l)
            if pending is None:
                h = self._norm(x, bp, "ln_1")
            else:
                x, h = self._add_norm(x, pending, bp, "ln_1")
            y, extra = attn(h, bp, l)
            got.append(extra)
            x, h = self._add_norm(x, y, bp, "ln_2")
            pending = self._mlp(h, bp)
        return x + pending, got

    @torch.no_grad()
    def paged_decode(self, stacked: Params, x, view, page):
        """Layer loop for one paged decode token; the pool is written in
        place.  Returns (x, view)."""
        x, _ = self._serve_layers(stacked, x, lambda h, bp, l: (
            self._paged_attn_decode(h, bp, view, l, page), None))
        return x, view

    def _paged_verify_attn(self, h, bp: Params, view, l: int, page):
        """Attention half of one verify step on ln_1's output h (S, K1,
        D): the projected attention output, before its residual.  The
        pool is READ-ONLY here (the committed prefix through the block
        tables); the span's K/V come back for the post-acceptance
        commit."""
        c = self.config
        s, k1, _ = h.shape
        qkv = linear(h, self._bw(bp, "attn.qkv.w"), bp.get("attn.qkv.b"))
        q, k, v = qkv.split(c.n_embd, dim=-1)

        def heads(z):  # (S, K1, D) -> (S, H, K1, Dh)
            return z.reshape(s, k1, c.n_head, c.head_dim).transpose(1, 2)

        kh, vh = heads(k), heads(v)
        y = self._paged_attention(heads(q), view, l, page, span_kv=(kh, vh))
        y = y.transpose(1, 2).reshape(s, k1, c.n_embd)
        return (linear(y, self._bw(bp, "attn.proj.w"), bp.get("attn.proj.b")),
                (kh, vh))

    @torch.no_grad()
    def paged_verify(self, stacked: Params, x, view, page):
        """Layer loop for one speculative verify (JAX :740): x (S, K1, D)
        span activations, pool never written.  Returns (x, sks, svs), the
        span K/V stacked (L, S, KVH, K1, Dh) per side for
        `paged_append_span` to commit the accepted prefix."""
        x, kv = self._serve_layers(stacked, x, lambda h, bp, l: (
            self._paged_verify_attn(h, bp, view, l, page)))
        return (x, torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def head_span(self, x, params: Optional[Params] = None):
        """Final norm + lm_head at EVERY position of x (S, K1, D) ->
        (S, K1, V) f32 — the verify step scores every span position."""
        x = self.final_norm(x, params)
        return linear(x, self._lm_head_w(params), None).float()

    @torch.no_grad()
    def paged_prefill(self, idx, last_pos: int, block_ids, view,
                      block_tokens: int, stacked: Optional[Params] = None,
                      head_params: Optional[Params] = None):
        """Prompt pass for ONE request into the paged pool: idx (1, P)
        bucket-padded prompt, last_pos the true last prompt position,
        block_ids (P / block_tokens,) physical blocks (padding entries at
        scratch).  Returns ((1, V) f32 logits at last_pos, view)."""
        from ..serving.pool import paged_scatter
        x = self.embed(idx)
        if stacked is None:
            stacked = self.stacked_compute_params()
        cdt = resolved_cache_dtype(self.config)
        ks, vs = [], []
        for l in range(self.config.n_layer):
            x, (k, v) = self._block(x, self._layer(stacked, l),
                                    return_kv=True)
            # each layer's (1, H, P, Dh) views of its qkv product, read
            # where they lie (cast first only when the cache's dtype
            # differs, so the codec reads the value rounded to it)
            ks.append(k.to(cdt))
            vs.append(v.to(cdt))
        view = paged_scatter(view, ks, vs, block_ids, block_tokens)
        return self.head(x, position=last_pos, params=head_params)[:, 0], view

    # -- generate: the sampling loop (JAX :1204-1280) ------------------------

    # tokens a block of generate's private pool (the serving default)
    GEN_BLOCK_TOKENS = 16

    def _gen_cache(self, b: int, total: int) -> "GenCache":
        """The private pool for B rows of `total` positions at
        `resolved_cache_dtype`: B*W usable blocks, W = ceil(total /
        GEN_BLOCK_TOKENS), row b's table [1 + b*W, 1 + (b+1)*W).  int8 /
        fp8 caches are refused, as JAX's cache_dtype refuses them."""
        from ..serving.pool import PagedKVPool
        c = self.config
        cdt = resolved_cache_dtype(c)
        if cdt not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(
                f"generate's cache rests in f32, bf16 or f16, not {cdt}: "
                "int8/fp8 cache compression lives in the serving pool "
                "(ServeConfig(quant=...))")
        bt = self.GEN_BLOCK_TOKENS
        w = -(-total // bt)
        pool = PagedKVPool(n_layer=c.n_layer,
                           kv_heads=getattr(c, "kv_heads", c.n_head),
                           head_dim=c.head_dim, num_blocks=b * w,
                           block_tokens=bt, dtype=cdt, device=self.device)
        tables = torch.tensor(pool.alloc(b * w), dtype=torch.int32,
                              device=self.device).view(b, w)
        p = torch.arange(total, device=self.device)
        return GenCache(
            view=pool.view, tables=tables,
            blk=tables.long()[:, p // bt].t().contiguous(),
            off=(p % bt)[:, None].expand(total, b).contiguous(),
            pos=p.to(torch.int32)[:, None].expand(total, b).contiguous())

    def _prefill_body(self, x, bp: Params):
        """One block of generate's prompt pass: (x, (k, v)) (JAX :479).  A
        family whose block returns more (MoE's aux term) drops it here."""
        return self._block(x, bp, return_kv=True)

    @torch.no_grad()
    def _prefill(self, idx, cache: "GenCache", stacked: Params,
                 head_params: Params):
        """generate's prompt pass (JAX `_prefill`, :485): the (B, T0)
        prompt through every block in one batch, every layer's K/V written
        into the cache at positions [0, T0) by one `kv_write` (row 10kv),
        and the (B, V) f32 logits at the last position."""
        from ..serving import pool as pool_mod
        t0 = idx.shape[1]
        x = self.embed(idx)
        cdt = cache.view.k.dtype
        ks, vs = [], []
        for l in range(self.config.n_layer):
            x, (k, v) = self._prefill_body(x, self._layer(stacked, l))
            # (B, T0, KVH, Dh) views: row b*T0 + t is position t of row b
            ks.append(k.to(cdt).transpose(1, 2))
            vs.append(v.to(cdt).transpose(1, 2))
        pool_mod.kv_write(cache.view, ks, vs,
                          cache.blk[:t0].t().reshape(-1),
                          cache.off[:t0].t().reshape(-1), 0)
        return self.head(x, params=head_params)[:, 0]

    @torch.no_grad()
    def _decode_step(self, tok, i: int, cache: "GenCache", stacked: Params,
                     head_params: Params):
        """One token a row at position i (JAX's loop body, :557-565):
        `_embed_decode`, the paged decode over the cache (the step's K/V
        appended at i), the head: (B, V) f32 logits."""
        page = cache.page(i)
        x = self._embed_decode(tok, page.pos)
        x, _ = self.paged_decode(stacked, x, cache.view, page)
        return self.head(x, params=head_params)[:, 0]

    @torch.no_grad()
    def generate(self, idx, max_new_tokens: int, *,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 use_cache: bool = True) -> torch.Tensor:
        """Autoregressive sampling (JAX :1204): (B, T0) prompt -> (B, T0 +
        max_new_tokens) int64 tokens on the model's device.

        use_cache=True runs the prompt once (`_prefill`) and then one (B,
        1, D) paged decode step a token over the private cache; the last
        token is only sampled, so N new tokens take N - 1 decode steps.
        use_cache=False re-runs `apply` over a fixed (B, block_size)
        buffer a token.  temperature 0 is greedy and needs no generator;
        any other temperature needs an explicit `generator` (no silent
        seed), whose draws are not JAX's bits; sampling goes through the
        one core shared with the serving tier (models/sampling.py)."""
        c = self.config
        idx = torch.as_tensor(idx, device=self.device).long()
        b, t0 = idx.shape
        total = t0 + max_new_tokens
        if total > c.block_size:
            raise ValueError(f"prompt {t0} + new {max_new_tokens} tokens > "
                             f"block_size {c.block_size}")
        if temperature != 0.0 and generator is None:
            raise ValueError(
                "stochastic sampling (temperature != 0) requires an "
                "explicit generator; pass generator=torch.Generator(...)"
                ".manual_seed(...) or use temperature=0.0 for greedy "
                "decoding")
        if not use_cache:
            buf = torch.zeros((b, c.block_size), dtype=torch.long,
                              device=self.device)
            buf[:, :t0] = idx
            for i in range(t0, total):
                logit = self.apply(buf, position=i - 1)[:, 0]
                buf[:, i] = sample_logits(logit, generator, temperature,
                                          top_k)
            return buf[:, :total]
        buf = torch.zeros((b, total), dtype=torch.long, device=self.device)
        buf[:, :t0] = idx
        if max_new_tokens == 0:
            return buf
        stacked = self.stacked_compute_params()
        head_params = self.head_compute_params()
        cache = self._gen_cache(b, total)
        logits = self._prefill(idx, cache, stacked, head_params)
        # N-1 decode steps: the last token needs only its sample
        for i in range(t0, total - 1):
            nxt = sample_logits(logits, generator, temperature, top_k)
            buf[:, i] = nxt
            logits = self._decode_step(nxt, i, cache, stacked, head_params)
        buf[:, total - 1] = sample_logits(logits, generator, temperature,
                                          top_k)
        return buf


class GenCache(NamedTuple):
    """generate's dense cache in the paged pool's layout: `view` the
    private pool's tensors, `tables` (B, W) int32 each row's blocks, and
    per position p the write coordinates of every row, (total, B) each:
    `blk` and `off` int64, `pos` int32 (= p, the mask bound)."""

    view: Any
    tables: torch.Tensor
    blk: torch.Tensor
    off: torch.Tensor
    pos: torch.Tensor

    def page(self, i: int):
        """The decode step's PageRef at position i (contiguous rows)."""
        from ..serving.pool import PageRef
        return PageRef(self.tables, self.blk[i], self.off[i], self.pos[i])
