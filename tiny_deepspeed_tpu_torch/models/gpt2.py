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
`rng` key, at the JAX package's three sites with its key tree.

Under the distributed engines `apply` takes the rank's
`parallel.mesh.ParallelContext` (`pctx`).  With the sequence split over
a seq group, the rank holds positions [s*Tl, (s+1)*Tl): it adds those
rows of `wpe` (JAX slices the global `wpe[:T]` and shards it, :819-824),
attention runs as ring attention (`ops.attention.sharded_attention`)
and the loss is the mean over the rank's own tokens (the engine averages
it).  The ring's autograd Function sits inside each block's
`torch.utils.checkpoint`, so the backward's recompute re-runs the ring
forward and its point-to-point rotations.  That is correct: every rank
of the group recomputes the same layers in the same order, so the
rotations pair up as they did in the forward.  Dropout on more than one
rank raises: the port's masks are not JAX's (PERF.md), and keeping them
invariant to the rank count is later work (ROADMAP.md).

Serving: the `return_kv` prefill hook, the paged decode step, the
speculative verify span (`paged_verify`, `head_span`; also the prefix
cache's suffix prefill) and the inference head, all without a graph.  ZeRO-3's `gather_quant` belongs to
the distributed engines and is refused here rather than silently
ignored.
"""

from __future__ import annotations

import dataclasses
import math
import functools
from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from .. import rng as prng
from ..ops.attention import ATTENTION, sharded_attention
from ..ops.dispatch import resolve_device
from ..ops.embedding import embedding, renorm_weight
from ..ops.fused_xent import pallas_fused_xent
from ..ops.layernorm import layernorm
from ..ops.linear import linear
from ..ops.paged_attn import decode_attention, paged_attention
from ..ops.softmax_xent import fused_linear_xent, softmax_cross_entropy


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


def _dropout_keep(key: int, shape, keep: float, device) -> torch.Tensor:
    """Bernoulli(keep) mask drawn on `device` from a generator seeded with
    `key` at the moment of use: a remat recompute redraws it exactly."""
    g = torch.Generator(device=device).manual_seed(key)
    return torch.rand(shape, generator=g, device=device) < keep


def _dropout(x, key: int, rate: float):
    """Inverted dropout (JAX :228-234): zero with probability `rate`,
    survivors scaled 1/(1-rate)."""
    keep = 1.0 - rate
    mask = _dropout_keep(key, x.shape, keep, x.device)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)

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

    def __init__(self, config: GPTConfig,
                 device: Union[None, str, torch.device] = None):
        super().__init__()
        if config.gather_quant is not None:
            raise ValueError(
                "GPTConfig gather_quant: not ported yet — the quantized "
                "ZeRO-3 weight gather comes with the distributed engines "
                "(ROADMAP.md)")
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

    def stacked_compute_params(self, params: Optional[Params] = None
                               ) -> Params:
        """The "h.*" tensors, keys without the "h." prefix, cast to the
        compute dtype ONCE per step (the serving engine keeps the result:
        params are frozen while serving).  Layer l is `{k: v[l]}`."""
        p = self.param_dict() if params is None else params
        cd = self.config.compute_dtype
        return {k[2:]: v.to(cd) for k, v in p.items() if k.startswith("h.")}

    def head_compute_params(self, params: Optional[Params] = None) -> Params:
        """The head's tensors (final norm + lm_head) in the compute dtype,
        cast once — the inference head reads them every decode step."""
        p = self.param_dict() if params is None else params
        cd = self.config.compute_dtype
        names = ["ln_f.w", "ln_f.b",
                 "wte" if self.config.tie_weights else "lm_head.w"]
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

    def embed_tokens(self, idx: torch.Tensor) -> torch.Tensor:
        """wte gather (+ optional row-norm cap) -> (B, T, D) compute dtype."""
        c = self.config
        if idx.shape[1] > c.block_size:
            raise ValueError(
                f"sequence length {idx.shape[1]} > block_size {c.block_size}")
        tok = embedding(idx, self.get_parameter("wte"))
        if c.wte_max_norm is not None:
            tok = renorm_weight(tok, c.wte_max_norm)
        return tok.to(c.compute_dtype)

    def embed(self, idx: torch.Tensor, pctx=None) -> torch.Tensor:
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
        tok = self.embed_tokens(idx)
        return tok + self.get_parameter("wpe")[off:off + t].to(
            tok.dtype)[None]

    def _block(self, x, bp: Params, return_kv: bool = False,
               dkey: Optional[int] = None, pctx=None):
        """One pre-LN block.  x (B, T, D) compute dtype; bp this layer's
        compute-dtype params.  return_kv also returns this layer's (k, v)
        head tensors — the prefill hook.  dkey, this layer's dropout key,
        drops after attn.proj (site 0) and after mlp.proj (site 1), JAX
        :370-379.  pctx routes attention (`sharded_attention`)."""
        c = self.config
        b, t, d = x.shape
        h = layernorm(x, bp["ln_1.w"], bp["ln_1.b"])
        qkv = linear(h, bp["attn.qkv.w"], bp.get("attn.qkv.b"))
        q, k, v = qkv.split(d, dim=-1)

        def heads(z):  # (B, T, D) -> (B, H, T, Dh)
            return z.reshape(b, t, c.n_head, c.head_dim).transpose(1, 2)

        kh, vh = heads(k), heads(v)
        y = sharded_attention(heads(q), kh, vh, c.attn_impl, pctx)
        y = y.transpose(1, 2).reshape(b, t, d)
        y = linear(y, bp["attn.proj.w"], bp.get("attn.proj.b"))
        if dkey is not None:
            y = _dropout(y, prng.fold_in(dkey, 0), c.dropout)
        x = x + y
        h = self._mlp(x, bp)
        if dkey is not None:
            h = _dropout(h, prng.fold_in(dkey, 1), c.dropout)
        x = x + h
        return (x, (kh, vh)) if return_kv else x

    def _mlp(self, x, bp: Params):
        h = layernorm(x, bp["ln_2.w"], bp["ln_2.b"])
        h = linear(h, bp["mlp.fc.w"], bp.get("mlp.fc.b"))
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu(approximate=True)
        return linear(h, bp["mlp.proj.w"], bp.get("mlp.proj.b"))

    def final_norm(self, x, params: Optional[Params] = None):
        cd = self.config.compute_dtype
        p = self.param_dict() if params is None else params
        return layernorm(x, p["ln_f.w"].to(cd), p["ln_f.b"].to(cd))

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
        """(x, bp) -> x under the configured remat policy (JAX
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
        same inputs, and redraws the same dropout masks (each from a
        generator seeded with its key when it is drawn)."""
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
            # dropout masks come from generators seeded with dkey), so no
            # RNG state needs restoring for the recompute
            return ckpt.checkpoint(self._block, x, bp, dkey=dkey, pctx=pctx,
                                   use_reentrant=False,
                                   preserve_rng_state=False, **kw)
        return block

    def apply(self, idx: torch.Tensor,
              targets: Optional[torch.Tensor] = None,
              position: Optional[int] = None, rng: Optional[int] = None,
              pctx=None):
        """Full forward of (B, T) tokens.  With `targets` (B, T): the mean
        loss, differentiable (JAX `apply(params, idx, targets)`).
        Without: (B, 1, V) f32 logits at `position` (default the last),
        computed without a graph.  `rng` (an integer key, training only)
        turns on dropout when config.dropout > 0: the embedding's, then
        one key per layer (JAX `_dropout_setup`, :902-912).  `pctx`, the
        rank's ParallelContext (training only): (B, T) is then this rank's
        block of the global batch and the loss its own tokens' mean."""
        if pctx is not None and targets is None:
            raise ValueError("apply(pctx=...) is the training forward: "
                             "pass targets")
        if targets is None:
            with torch.no_grad():
                x = self.embed(idx)
                stacked = self.stacked_compute_params()
                for l in range(self.config.n_layer):
                    x = self._block(x, self._layer(stacked, l))
                return self.head(x, position)
        x = self.embed(idx, pctx)
        c = self.config
        dkeys = [None] * c.n_layer
        if rng is not None and c.dropout:
            if pctx is not None and pctx.is_multi_device:
                raise ValueError(
                    "dropout on more than one rank is not ported yet: the "
                    "masks would change with the rank count (ROADMAP.md)")
            keys = prng.split(rng, c.n_layer + 1)
            x = _dropout(x, keys[0], c.dropout)
            dkeys = keys[1:]
        block = self._block_fn()
        for bp, dkey in zip(self._layers(self.stacked_compute_params()),
                            dkeys):
            x = block(x, bp, dkey, pctx)
        return self.head(x, targets=targets, pctx=pctx)

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

    def _paged_attention(self, q, view, l: int, page, span_kv=None):
        """Pool-panel attention (JAX :585): the paged kernels on the card,
        the plain gather + `ops.paged_attn.decode_attention` or
        `span_attention` on the CPU.  span_kv = (sk, sv) switches to the
        span-verify mask."""
        return paged_attention(q, view, page, l, span_kv=span_kv)

    def _paged_attn_decode(self, x, bp: Params, view, l: int, page):
        """Attention half of one paged decode step.  x (S, 1, D)."""
        from ..serving.pool import paged_append
        c = self.config
        s = x.shape[0]
        h = layernorm(x, bp["ln_1.w"], bp["ln_1.b"])
        qkv = linear(h, bp["attn.qkv.w"], bp.get("attn.qkv.b"))
        q, k, v = qkv.split(c.n_embd, dim=-1)

        def heads1(z):  # (S, 1, D) -> (S, H, 1, Dh)
            return z.reshape(s, 1, c.n_head, c.head_dim).transpose(1, 2)

        paged_append(view, heads1(k)[:, :, 0], heads1(v)[:, :, 0], l, page)
        y = self._paged_attention(heads1(q), view, l, page)
        y = y.transpose(1, 2).reshape(s, 1, c.n_embd)
        return x + linear(y, bp["attn.proj.w"], bp.get("attn.proj.b"))

    @torch.no_grad()
    def paged_decode(self, stacked: Params, x, view, page):
        """Layer loop for one paged decode token; the pool is written in
        place.  Returns (x, view)."""
        for l in range(self.config.n_layer):
            bp = self._layer(stacked, l)
            x = self._paged_attn_decode(x, bp, view, l, page)
            x = x + self._mlp(x, bp)
        return x, view

    def _paged_verify_attn(self, x, bp: Params, view, l: int, page):
        """Attention half of one verify step: x (S, K1, D).  The pool is
        READ-ONLY here (the committed prefix through the block tables);
        the span's K/V come back for the post-acceptance commit."""
        c = self.config
        s, k1, _ = x.shape
        h = layernorm(x, bp["ln_1.w"], bp["ln_1.b"])
        qkv = linear(h, bp["attn.qkv.w"], bp.get("attn.qkv.b"))
        q, k, v = qkv.split(c.n_embd, dim=-1)

        def heads(z):  # (S, K1, D) -> (S, H, K1, Dh)
            return z.reshape(s, k1, c.n_head, c.head_dim).transpose(1, 2)

        kh, vh = heads(k), heads(v)
        y = self._paged_attention(heads(q), view, l, page, span_kv=(kh, vh))
        y = y.transpose(1, 2).reshape(s, k1, c.n_embd)
        x = x + linear(y, bp["attn.proj.w"], bp.get("attn.proj.b"))
        return x, (kh, vh)

    @torch.no_grad()
    def paged_verify(self, stacked: Params, x, view, page):
        """Layer loop for one speculative verify (JAX :740): x (S, K1, D)
        span activations, pool never written.  Returns (x, sks, svs), the
        span K/V stacked (L, S, KVH, K1, Dh) per side for
        `paged_append_span` to commit the accepted prefix."""
        sks, svs = [], []
        for l in range(self.config.n_layer):
            bp = self._layer(stacked, l)
            x, (k, v) = self._paged_verify_attn(x, bp, view, l, page)
            x = x + self._mlp(x, bp)
            sks.append(k)
            svs.append(v)
        return x, torch.stack(sks), torch.stack(svs)

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
        ks, vs = [], []
        for l in range(self.config.n_layer):
            x, (k, v) = self._block(x, self._layer(stacked, l),
                                    return_kv=True)
            ks.append(k)
            vs.append(v)
        cdt = resolved_cache_dtype(self.config)
        view = paged_scatter(view, torch.stack(ks).to(cdt),
                             torch.stack(vs).to(cdt), block_ids,
                             block_tokens)
        return self.head(x, position=last_pos, params=head_params)[:, 0], view
