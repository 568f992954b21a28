# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""GPT-2 forward for serving, in PyTorch.

Counterpart of `tiny_deepspeed_tpu/models/gpt2.py`: same configuration,
same parameter names and layouts (a flat dotted name space with the L
transformer blocks STACKED on a leading axis, linear weights (in, out)),
same pre-LN block, f32 master parameters and a compute dtype (bf16 on
gpt2-124m) cast once per serving engine.  Parameters are registered on
nested submodules so `named_parameters()` yields exactly the JAX
package's flat dict keys, and `load_state_dict(params_from_numpy(...))`
takes the JAX package's weights.

This slice is the serving forward: the training forward's `return_kv`
prefill hook, the paged decode step and the inference head.  The loss
head, dropout, remat and ZeRO-3's `gather_quant` belong to the training
slices and are refused here rather than silently ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import ATTENTION
from ..ops.dispatch import resolve_device
from ..ops.embedding import embedding, renorm_weight
from ..ops.layernorm import layernorm
from ..ops.linear import linear
from ..ops.paged_attn import decode_attention, paged_attention


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model hyperparameters (JAX models/gpt2.py:53).  `remat` defaults
    to False here: there is no backward to rematerialize yet."""

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
    remat: bool = False
    wte_max_norm: Optional[float] = None
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


class GPT2Model(nn.Module):
    """GPT-2 with its parameters on `device` (the card unless the caller
    passes device="cpu"; without CUDA and without a device it raises)."""

    # the serving engine's paged decode batches slots at mixed positions
    paged_decode_capable = True

    def __init__(self, config: GPTConfig,
                 device: Union[None, str, torch.device] = None):
        super().__init__()
        refused = {"dropout": config.dropout != 0.0, "remat": config.remat,
                   "gather_quant": config.gather_quant is not None}
        bad = [k for k, on in refused.items() if on]
        if bad:
            raise ValueError(
                f"GPTConfig {bad}: training / ZeRO-3 features, not ported "
                "yet (the port runs the serving forward only)")
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
            # frozen: the port has no backward yet
            mod.register_parameter(leaf, nn.Parameter(
                torch.zeros(shape, dtype=config.param_dtype,
                            device=self.device), requires_grad=False))

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
        compute dtype ONCE (the engine keeps the result: params are
        frozen while serving).  Layer l is `{k: v[l]}`."""
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

    def embed(self, idx: torch.Tensor) -> torch.Tensor:
        """Token + position embedding -> (B, T, D) in compute dtype."""
        t = idx.shape[1]
        tok = self.embed_tokens(idx)
        return tok + self.get_parameter("wpe")[:t].to(tok.dtype)[None]

    def _block(self, x, bp: Params, return_kv: bool = False):
        """One pre-LN block.  x (B, T, D) compute dtype; bp this layer's
        compute-dtype params.  return_kv also returns this layer's (k, v)
        head tensors — the prefill hook."""
        c = self.config
        b, t, d = x.shape
        h = layernorm(x, bp["ln_1.w"], bp["ln_1.b"])
        qkv = linear(h, bp["attn.qkv.w"], bp.get("attn.qkv.b"))
        q, k, v = qkv.split(d, dim=-1)

        def heads(z):  # (B, T, D) -> (B, H, T, Dh)
            return z.reshape(b, t, c.n_head, c.head_dim).transpose(1, 2)

        kh, vh = heads(k), heads(v)
        y = ATTENTION[c.attn_impl](heads(q), kh, vh)
        y = y.transpose(1, 2).reshape(b, t, d)
        x = x + linear(y, bp["attn.proj.w"], bp.get("attn.proj.b"))
        x = x + self._mlp(x, bp)
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
             params: Optional[Params] = None):
        """Final norm + lm_head at ONE position (default the last) ->
        (B, 1, V) f32 logits.  The norm is per row, so selecting the row
        first gives the JAX head's values at a fraction of the rows."""
        x = x[:, -1:] if position is None else x[:, position:position + 1]
        x = self.final_norm(x, params)
        return linear(x, self._lm_head_w(params), None).float()

    @torch.no_grad()
    def apply(self, idx: torch.Tensor, position: Optional[int] = None):
        """Full forward of (B, T) tokens -> (B, 1, V) f32 logits at
        `position` (default the last) — JAX `apply` without targets."""
        x = self.embed(idx)
        stacked = self.stacked_compute_params()
        for l in range(self.config.n_layer):
            x = self._block(x, self._layer(stacked, l))
        return self.head(x, position)

    # -- paged KV-cache decode (the serving tier) ---------------------------

    def _embed_decode(self, tok: torch.Tensor, pos: torch.Tensor):
        """One token per row at its own position -> (S, 1, D)."""
        x = self.embed_tokens(tok[:, None])
        wp = self.get_parameter("wpe")[pos.long()][:, None]
        return x + wp.to(x.dtype)

    def _decode_attention(self, q, ck, cv, pos):
        return decode_attention(q, ck, cv, pos)

    def _paged_attention(self, q, view, l: int, page):
        """Pool-panel attention: the paged decode kernel on the card, the
        plain gather + `_decode_attention` on the CPU."""
        return paged_attention(q, view, page, l)

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

    def paged_decode(self, stacked: Params, x, view, page):
        """Layer loop for one paged decode token; the pool is written in
        place.  Returns (x, view)."""
        for l in range(self.config.n_layer):
            bp = self._layer(stacked, l)
            x = self._paged_attn_decode(x, bp, view, l, page)
            x = x + self._mlp(x, bp)
        return x, view

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
