# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Mixture-of-Experts GPT in PyTorch: top-k routed experts, trained.

Counterpart of `tiny_deepspeed_tpu/models/moe.py`: the same configuration
(`MoEConfig`, `MOE_PRESETS`), parameter names, layouts and insertion
order, the same router, both dispatches and the same loss.  `MoEGPT` is a
`GPT2Model` whose blocks replace the MLP by a router and E experts and
return their Switch-Transformer load-balancing term beside x; the layer
loop sums those terms through each block's remat checkpoint and `apply`
adds `aux_loss_weight * sum / n_layer` to the loss.  Every engine and the
fp8 gather run it; the serving engine refuses it (`paged_decode_capable
= False`, as in JAX: static per-expert capacity over a batch of slots at
mixed positions would skew the routing).  `generate` decodes it: its
prompt pass drops the aux term (`_prefill_body`) and each decode step
routes the step's B tokens together with the drop-free capacity B*k
(`_mlp`, the decode's MLP hook; JAX `_block_decode`, :466-480), under
either dispatch.

- The router reads its input and its weight in f32 (`stacked_compute_
  params` and ZeRO-3's `prepare` keep `moe.router.w` f32 through
  `_stacked_dtype`; the fp8 gather leaves it out): softmax, top-k with
  ties to the lower expert index, as `jax.lax.top_k` breaks them
  (`torch.topk` does not: a stable descending sort does), gates
  renormalised.
- "einsum" dispatch (`_route`): GShard's one-hot tables of shape (S, E,
  C), C = max(1, int(cf * k * S / E)), slots filled choice by choice, all
  first choices before any second, in token order; the two contractions
  over the tokens are cuBLAS products, and the tables are built in the
  compute dtype (JAX builds them in f32 and casts: the same values).
- "sort" dispatch (`_route_sort`): a stable sort of the (token, choice)
  pairs by expert fills each expert's C slots token by token; the slot
  gather and the gated combine are one autograd Function each way
  (`SlotRows`) that sums a token's k slots in choice order, forward and
  backward, so the sums are the same on every run (no atomics).
- `_expert_ffn`: (E, C, D) through fc, tanh GELU and proj on batched
  cuBLAS products, for both dispatches.

Ranks.  JAX's "einsum" path routes the GLOBAL (B*T) panel under GSPMD:
capacity from the global S, slots in global token order (b-major, t
inside), the load-balancing fractions over every token.  The port splits
the batch by hand, so under a distributed engine each rank all-gathers
its per-row, per-choice expert counts (one (k, B_local, E) int all-gather
a layer, also in the remat recompute) and takes from them its slot
offsets and the global totals; it runs the experts over all E*C slots,
the other ranks' slots holding zero rows that its combine never reads.
Its load-balancing term is E * sum(frac_global * mean_local(probs)): the
engine sums the ranks' gradients of loss / world, so the ranks' terms
average to JAX's value and their gradients sum to JAX's.  The "sort"
path is shard-local under pure data parallelism (capacity from the local
S, the term averaged over ranks: JAX's `shard_map` + `pmean`) and falls
back to "einsum" under a sequence split (`effective_dispatch`).  Expert,
tensor and pipeline parallelism stay refused by the engines.

Nothing here is a hand-written kernel: the router, the tables and the
experts are plain `jnp` in JAX (XLA fusions and dots).  The block's
norms and attention are GPT-2's: LayerNorm, the fused residual add +
LayerNorm and FA2 on their CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import rng as prng
from .gpt2 import GPT2Model, GPTConfig, Params, _dropout

_DISPATCHES = ("einsum", "sort")


@dataclasses.dataclass(frozen=True)
class MoEConfig(GPTConfig):
    """GPTConfig + the routing hyperparameters (JAX :39-70)."""

    n_expert: int = 8
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    ff_mult: int = 4  # expert hidden = ff_mult * n_embd
    # "einsum" (one-hot (S, E, C) tables contracted over the tokens) or
    # "sort" (a stable sort of the tokens by expert, a row gather and a
    # gated combine); `effective_dispatch` says which one a step runs
    moe_dispatch: str = "einsum"


def effective_dispatch(cfg, pctx) -> str:
    """The dispatch a step with this config and rank layout runs (JAX
    :73-84): "einsum" stays "einsum"; "sort" runs on one device and
    shard-local under pure data parallelism, and falls back to "einsum"
    under a sequence split.  `pctx` is the rank's ParallelContext, None
    on one device."""
    if cfg.moe_dispatch != "sort":
        return cfg.moe_dispatch
    if pctx is None or not pctx.is_multi_device:
        return "sort"
    if pctx.seq_size > 1:
        return "einsum"
    return "sort"


# entry-point presets (one flat namespace with gpt2-* / llama-*,
# models/__init__.ALL_PRESETS): "moe-tiny" for the CPU, "moe-8x124m" the
# GPT-2-124M skeleton with 8 top-2 experts a block, 559,867,392 params
MOE_PRESETS: Dict[str, MoEConfig] = {
    "moe-tiny": MoEConfig(block_size=256, vocab_size=512, n_layer=2,
                          n_head=2, n_embd=64, n_expert=4, expert_top_k=2,
                          compute_dtype=torch.float32),
    "moe-8x124m": MoEConfig(n_layer=12, n_head=12, n_embd=768, n_expert=8,
                            expert_top_k=2),
}


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (N, D) picked by idx, a zero row where idx == N.  A 1-D
    idx gives one row each; a 2-D idx (S, k) sums row s's k picks in
    order j = 0, 1, ..."""
    xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
    if idx.dim() == 1:
        return xp[idx]
    out = xp[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        out = out + xp[idx[:, j]]
    return out


class SlotRows(torch.autograd.Function):
    """`_rows(x, idx)` whose gradient is `_rows(g, tidx)`, tidx the
    transpose of idx: the sort dispatch's slot gather (idx = src, each
    slot's token; tidx = inv, each token's k slots) and its combine (idx
    = inv, tidx = src).  A token's rows are summed in choice order both
    ways, where a scatter-add would add them in whatever order its
    atomics land."""

    @staticmethod
    def forward(ctx, x, idx, tidx):
        ctx.save_for_backward(tidx)
        return _rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        (tidx,) = ctx.saved_tensors
        return _rows(g, tidx), None, None


class MoEGPT(GPT2Model):
    """GPT-2 with MoE MLPs on `device` (the card unless the caller passes
    device="cpu"): GPT2Model's training contract, `init` included (the
    router and experts N(0, 0.02), `*proj.w` N(0, 0.02/sqrt(2L)), biases
    0)."""

    # the serving engine refuses it (JAX :140-143)
    paged_decode_capable = False
    # the layer loop carries the aux-loss sum, which the schedule's
    # executors do not thread: the schedule refuses it (JAX :137-138)
    grad_bucket_capable = False
    gather_prefetch_capable = False
    # the per-layer health probe rides no MoE block (JAX moe.py:139)
    layer_health_capable = False

    def __init__(self, config: MoEConfig, device=None):
        if config.moe_dispatch not in _DISPATCHES:
            raise ValueError(
                f"moe_dispatch={config.moe_dispatch!r}: expected 'einsum' "
                "or 'sort' (a typo here would silently run the einsum path "
                "while being recorded as a sort A/B)")
        super().__init__(config, device=device)

    # -- parameters ---------------------------------------------------------

    def param_shapes(self) -> Dict[str, tuple]:
        """{name: shape} in the JAX package's insertion order (:191-217)."""
        c = self.config
        d, l, v, t, e = (c.n_embd, c.n_layer, c.vocab_size, c.block_size,
                         c.n_expert)
        f = c.ff_mult * d
        shapes = {
            "wte": (v, d), "wpe": (t, d),
            "h.ln_1.w": (l, d), "h.ln_1.b": (l, d),
            "h.attn.qkv.w": (l, d, 3 * d), "h.attn.qkv.b": (l, 3 * d),
            "h.attn.proj.w": (l, d, d), "h.attn.proj.b": (l, d),
            "h.ln_2.w": (l, d), "h.ln_2.b": (l, d),
            "h.moe.router.w": (l, d, e),
            "h.moe.fc.w": (l, e, d, f), "h.moe.fc.b": (l, e, f),
            "h.moe.proj.w": (l, e, f, d), "h.moe.proj.b": (l, e, d),
            "ln_f.w": (d,), "ln_f.b": (d,),
            "lm_head.w": (d, v),
        }
        if not c.bias:
            for name in ("h.attn.qkv.b", "h.attn.proj.b", "h.moe.fc.b",
                         "h.moe.proj.b"):
                del shapes[name]
        if c.tie_weights:
            del shapes["lm_head.w"]
        return shapes

    def _quant_eligible(self, name: str, shape) -> bool:
        """The router stays out of the fp8 gather (JAX :482-485)."""
        return super()._quant_eligible(name, shape) and "router" not in name

    def _stacked_dtype(self, name: str):
        """The router rests in its parameter dtype, f32 (JAX :487-492)."""
        if name == "moe.router.w":
            return self.config.param_dtype
        return super()._stacked_dtype(name)

    # -- routing ------------------------------------------------------------

    def _router(self, x, router_w):
        """The router head on x (S, D) f32: (gate_vals (S, k) renormalised,
        expert_idx (S, k), probs (S, E) f32) (JAX :274-291).  Top-k as a
        stable descending sort: equal probabilities go to the lower expert
        index, as `jax.lax.top_k` gives them."""
        k = self.config.expert_top_k
        probs = torch.softmax((x @ router_w).float(), dim=-1)
        expert_idx = torch.sort(probs, dim=-1, descending=True,
                                stable=True).indices[:, :k]
        gate_vals = probs.gather(1, expert_idx)
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        return gate_vals, expert_idx, probs

    def _aux(self, probs, first, tokens: int):
        """The Switch-Transformer term E * sum(frac * mean(probs)): frac,
        the share of `tokens` whose first choice is each expert (`first`,
        their (E,) count), mean(probs) over the rows of `probs`."""
        frac = first.float() / tokens
        return self.config.n_expert * torch.sum(frac * probs.mean(0))

    def _capacity(self, tokens: int, capacity=None) -> int:
        """Slots an expert holds for a panel of `tokens` (JAX :256), or
        `capacity` when given (the decode's drop-free S*k)."""
        c = self.config
        return capacity or max(1, int(c.capacity_factor * c.expert_top_k
                                      * tokens / c.n_expert))

    def _slots(self, expert_idx, rows: int, pctx, capacity=None):
        """Each (token, choice)'s slot in its expert under the einsum
        path's fill (JAX :262-270): choice by choice, in global token
        order.  expert_idx (S, k) holds `rows` rows of the rank's block;
        `capacity` overrides the formula's.  Returns (pos (S, k) int64,
        keep (S, k) bool, capacity, the global first-choice count (E,),
        the global token count).

        Per choice, a token's position is the number of earlier tokens of
        that choice on its expert plus the slots the earlier choices
        kept.  Under a distributed engine the earlier tokens are every
        row of the lower global rows and row b's lower seq chunks: their
        counts come from one all-gather of the rank's (rows, k, E) counts
        over the world, chunks ordered (data, row, seq) — the global
        order.  Integer arithmetic throughout: JAX's f32 cumsum of ones is
        exact at these sizes."""
        c = self.config
        e, k = c.n_expert, c.expert_top_k
        s = expert_idx.shape[0]
        onehot = F.one_hot(expert_idx.view(rows, s // rows, k), e)
        within = onehot.cumsum(1)              # (rows, t, k, E) inclusive
        chunks = within[:, -1].contiguous()    # (rows, k, E)
        mine = torch.arange(rows, device=expert_idx.device)
        world = 1
        if pctx is not None and pctx.is_multi_device:
            world = pctx.world
            got = chunks.new_empty(world * chunks.numel())
            dist.all_gather_into_tensor(got, chunks.view(-1),
                                        group=pctx.world_group)
            chunks = got.view(pctx.data_size, pctx.seq_size, rows, k,
                              e).transpose(1, 2).reshape(-1, k, e)
            mine = ((pctx.data_rank * rows + mine) * pctx.seq_size
                    + pctx.seq_rank)
        tokens = s * world
        cap = self._capacity(tokens, capacity)
        total = chunks.sum(0)                  # (k, E) over the world
        kept = [torch.zeros_like(total[0])]    # slots used before choice j
        for j in range(k - 1):
            kept.append(torch.clamp(kept[-1] + total[j], max=cap))
        before = (chunks.cumsum(0) - chunks)[mine]          # (rows, k, E)
        pos = before[:, None] + within - 1 + torch.stack(kept)
        pos = pos.gather(-1, expert_idx.view(rows, -1, k, 1)).view(s, k)
        return pos, pos < cap, cap, total[0], tokens

    def _route(self, x, router_w, rows: int = 1, pctx=None,
               dtype=torch.float32, capacity=None):
        """The einsum path's tables (JAX :242-272) for x (S, D) f32, the
        rank's `rows` rows b-major: (dispatch (S, E, C), combine (S, E,
        C), aux), in `dtype` — the values JAX builds in f32, cast; C from
        `capacity` when given.  A
        token's k choices sit in k different experts, so every (token,
        expert, slot) takes at most one write: a dropped choice writes its
        zero into slot 0 of its own expert, in its own row."""
        c = self.config
        s = x.shape[0]
        e, k = c.n_expert, c.expert_top_k
        gate_vals, expert_idx, probs = self._router(x, router_w)
        pos, keep, cap, first, tokens = self._slots(expert_idx, rows, pctx,
                                                    capacity)
        tok = torch.arange(s, device=x.device)[:, None].expand(s, k)
        col = expert_idx * cap + torch.where(keep, pos, 0)
        dispatch = torch.zeros(s, e * cap, dtype=dtype, device=x.device)
        dispatch.index_put_((tok, col), keep.to(dtype))
        combine = torch.zeros(s, e * cap, dtype=dtype, device=x.device)
        combine.index_put_((tok, col),
                           torch.where(keep, gate_vals, 0.0).to(dtype))
        return (dispatch.view(s, e, cap), combine.view(s, e, cap),
                self._aux(probs, first, tokens))

    def _route_sort(self, x, router_w, capacity=None):
        """The sort path's tables (JAX :293-325) for x (S, D) f32, C from
        `capacity` when given: (src
        (E*C,) each slot's token, S where empty; gate (E*C,) f32 each
        slot's combine weight; aux; inv (S, k) each (token, choice)'s
        slot, E*C where dropped).  Slots fill token-major (a stable sort
        by expert); under overflow the dropped set can differ from the
        einsum path's first-choices-first fill."""
        c = self.config
        s = x.shape[0]
        e, k = c.n_expert, c.expert_top_k
        cap = self._capacity(s, capacity)
        gate_vals, expert_idx, probs = self._router(x, router_w)
        flat_e = expert_idx.reshape(-1)        # (S*k,) token-major
        order = torch.sort(flat_e, stable=True).indices
        sorted_e = flat_e[order]
        # one-hot sums, not `bincount`: on the card that reads its max
        # back to the host
        counts = F.one_hot(flat_e, e).sum(0)
        starts = counts.cumsum(0) - counts
        pos = torch.arange(s * k, device=x.device) - starts[sorted_e]
        keep = pos < cap
        # kept slots are unique; every dropped entry lands on dump slot
        # E*C with the same value (S, or a zero gate)
        slot = torch.where(keep, sorted_e * cap + pos, e * cap)
        src = torch.full((e * cap + 1,), s, dtype=torch.long,
                         device=x.device)
        src.index_put_((slot,), torch.where(keep, order // k, s))
        gate = torch.zeros(e * cap + 1, dtype=torch.float32,
                           device=x.device)
        gate.index_put_((slot,),
                        torch.where(keep, gate_vals.reshape(-1)[order], 0.0))
        inv = torch.empty_like(slot).scatter_(0, order, slot).view(s, k)
        aux = self._aux(probs, F.one_hot(expert_idx[:, 0], e).sum(0), s)
        return src[:e * cap], gate[:e * cap], aux, inv

    # -- forward ------------------------------------------------------------

    def _expert_ffn(self, xe, bp: Params):
        """(E, C, D) -> (E, C, D): the experts' fc, tanh GELU and proj on
        batched products, shared by both dispatches (JAX :399-410)."""
        h = torch.bmm(xe, self._bw(bp, "moe.fc.w"))
        if "moe.fc.b" in bp:
            h = h + bp["moe.fc.b"][:, None]
        h = F.gelu(h, approximate="tanh")
        ye = torch.bmm(h, self._bw(bp, "moe.proj.w"))
        if "moe.proj.b" in bp:
            ye = ye + bp["moe.proj.b"][:, None]
        return ye

    def _moe_mlp(self, x, bp: Params, pctx=None, capacity=None):
        """x (B, T, D) -> ((B, T, D), aux) (JAX :329-397).  The router
        reads x and its weight in f32; the einsum tables take x's dtype
        before the two contractions (in bf16 the gates round, as in
        JAX).  `capacity` overrides the slots an expert holds."""
        b, t, d = x.shape
        xs = x.reshape(b * t, d)
        router_w = bp["moe.router.w"].float()
        if effective_dispatch(self.config, pctx) == "sort":
            y, aux = self._moe_mlp_sort(xs, router_w, bp, capacity)
            return y.view(b, t, d), aux
        dispatch, combine, aux = self._route(xs.float(), router_w, rows=b,
                                             pctx=pctx, dtype=x.dtype,
                                             capacity=capacity)
        s, e, cap = dispatch.shape
        # (S, E*C)^T (S, D) and (S, E*C) (E*C, D): the contractions over
        # the tokens
        xe = dispatch.view(s, e * cap).t() @ xs
        ye = self._expert_ffn(xe.view(e, cap, d), bp)
        y = combine.view(s, e * cap) @ ye.view(e * cap, d)
        return y.view(b, t, d), aux

    def _moe_mlp_sort(self, xs, router_w, bp: Params, capacity=None):
        """The sort path on the flat (S, D) panel (JAX :412-430): gather
        each slot's token row (an empty slot a zero row), the experts,
        the gated outputs summed back into their tokens."""
        e, d = self.config.n_expert, xs.shape[1]
        src, gate, aux, inv = self._route_sort(xs.float(), router_w,
                                               capacity)
        cap = src.shape[0] // e
        xe = SlotRows.apply(xs, src, inv).view(e, cap, d)
        ye = self._expert_ffn(xe, bp).reshape(e * cap, d)
        y = SlotRows.apply(gate[:, None].to(ye.dtype) * ye, inv, src)
        return y.to(xs.dtype), aux

    def _block(self, x, bp: Params, return_kv: bool = False, dkey=None,
               pctx=None):
        """One pre-norm block with the MoE MLP (JAX :432-458): returns
        (x, aux), with return_kv ((x, aux), (k, v)).  The norms and the
        attention are GPT-2's hooks; dropout draws sites 0 and 1 of the
        layer's key, as GPT-2's block does."""
        c = self.config
        if pctx is not None and pctx.gather is not None:
            bp = pctx.gather.layer(bp)
        h = self._norm(x, bp, "ln_1")
        y, kv = self._attn(h, bp, pctx)
        if dkey is not None:
            y = _dropout(y, prng.fold_in(dkey, 0), c.dropout, pctx)
        x, h = self._add_norm(x, y, bp, "ln_2")
        y, aux = self._moe_mlp(h, bp, pctx)
        if dkey is not None:
            y = _dropout(y, prng.fold_in(dkey, 1), c.dropout, pctx)
        x = x + y
        return ((x, aux), kv) if return_kv else (x, aux)

    def _blocks(self, x, stacked: Params, dkeys, pctx=None, sched=None):
        """The layer loop with the blocks' aux terms summed in f32 through
        each block's checkpoint (its second output, under every remat
        policy): (x, aux_loss_weight * sum / n_layer) (JAX :512-527).
        No executor threads the aux term (`build_schedule` refuses)."""
        if sched is not None:
            raise ValueError("MoEGPT's layer loop cannot be handed to a "
                             "schedule executor (grad_bucket_capable / "
                             "gather_prefetch_capable are False)")
        c = self.config
        block = self._block_fn()
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp, dkey in zip(self._layers(stacked), dkeys):
            x, aux = block(x, bp, dkey, pctx)
            aux_sum = aux_sum + aux
        return x, c.aux_loss_weight * aux_sum / c.n_layer

    # -- generate (JAX :460-480) ----------------------------------------------

    def _prefill_body(self, x, bp: Params):
        """generate's prompt pass drops the aux term, a training quantity
        (JAX :460)."""
        (x, _aux), kv = self._block(x, bp, return_kv=True)
        return x, kv

    def _mlp(self, h, bp: Params):
        """The decode step's MLP (`_serve_layers`' hook; the training block
        calls `_moe_mlp` itself): the step's S = B tokens routed together
        under either dispatch with the drop-free capacity S*k — the
        training formula would collapse to ~1 slot at S = B — and the aux
        term dropped (JAX `_block_decode`, :466-480)."""
        s = h.shape[0] * h.shape[1]
        y, _aux = self._moe_mlp(h, bp,
                                capacity=s * self.config.expert_top_k)
        return y
