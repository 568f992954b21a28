# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Tensor and expert parallelism in one process (parallel/tensor.py,
parallel/mesh.py, the vocab-parallel head of ops/softmax_xent.py, the
engines' refusals), on the CPU.

Pinned here:

- `shard_leaf` / `unshard` round-trip every leaf of the `tiny`,
  `llama-tiny` and `moe-tiny` presets bit for bit at tp 2 and 4, ep 2
  and 4 and ep 2 x tp 2; GPT-2's fused qkv rests as the head-block
  permutation of JAX's contiguous shard (rank m: its heads' q | k | v);
- the layout's cuts are JAX's `tp_rules` / `ep_rules`, and the rank
  numbering is JAX's mesh order (data, seq, model, expert);
- every refusal has JAX's exception type and message: a split that does
  not divide the device count, n_head, a leaf dim under "model" and
  under "expert", Ulysses' local heads, the grad and gather slots with
  "model" / "expert" busy; the port's own: pipeline parallelism (the
  next slice), K/V heads the model axis does not divide (JAX's engine
  builds there), a given context that carries another split;
- the vocab-parallel loss (chunked and materialized) over a 2- and
  4-rank split, run through `one_process.lockstep`, equals the whole
  head's loss, dx and dW within 1e-6, also with fp8 products; `copy_to` /
  `reduce_from` are Megatron's f and g;
- `count_once`, `effective_dispatch` under EP / TP, and the training
  entry's flags (a split on one device refused; `--pipeline-parallel`
  refused by the engine, naming the next slice; torchrun with
  `--tensor-parallel 2` on 4 gloo ranks).

JAX is imported inside the tests.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import moe as moe_mod
from tiny_deepspeed_tpu_torch.ops import collectives as C
from tiny_deepspeed_tpu_torch.ops import matmul_fp8 as fp8_mod
from tiny_deepspeed_tpu_torch.ops import softmax_xent as X
from tiny_deepspeed_tpu_torch.parallel import one_process as OP
from tiny_deepspeed_tpu_torch.parallel import tensor as TP
from tiny_deepspeed_tpu_torch.parallel.mesh import (ParallelContext,
                                                     make_context)
from test_torch_dist import world1  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (preset, tp, ep): every family under the model axis, MoE also under
# the expert axis and both
LAYOUTS = [(p, tp, 1) for p in ("tiny", "llama-tiny", "moe-tiny")
           for tp in (2, 4)] + [("moe-tiny", 1, 2), ("moe-tiny", 1, 4),
                                ("moe-tiny", 2, 2)]


def _model(preset, **kw):
    return T.build_model(dataclasses.replace(T.ALL_PRESETS[preset], **kw),
                         device="cpu")


def _pctx(world, dp=1, sp=1, tp=1, ep=1, impl="ring"):
    """A context no collective ever runs on (refusal checks)."""
    return ParallelContext(world=world, rank=0, data_size=dp, seq_size=sp,
                           data_rank=0, seq_rank=0, seq_impl=impl,
                           model_size=tp, expert_size=ep)


@pytest.mark.parametrize("preset,tp,ep", LAYOUTS)
def test_shard_unshard_round_trip(preset, tp, ep):
    """Every leaf cut into its (model, expert) pieces and joined back:
    bit for bit; each piece of the local shape; a leaf the tables do
    not name is every rank's whole leaf."""
    kw = dict(n_head=4)
    if preset == "llama-tiny":
        kw["n_kv_head"] = 4
    m = _model(preset, **kw).init(torch.Generator().manual_seed(0))
    lay = TP.TPLayout(m, tp, ep)
    for n, whole in m.param_dict().items():
        cuts = lay.cuts[n]
        pieces = {}
        for mr in range(tp):
            for er in range(ep):
                coords = {"model": mr, "expert": er}
                p = TP.shard_leaf(whole, cuts, coords).clone()
                assert tuple(p.shape) == lay.shapes[n], n
                key = tuple(coords[c.axis] for c in cuts)
                if key in pieces:  # a replica along the other axis
                    assert torch.equal(pieces[key], p), n
                pieces[key] = p
        back = TP.unshard(pieces, cuts)
        assert back.shape == whole.shape and torch.equal(back, whole), n
        if not cuts:
            assert lay.shapes[n] == tuple(whole.shape)


@pytest.mark.parametrize("tp", [2, 4])
def test_qkv_rests_as_the_head_block_permutation(tp):
    """Model rank m holds q, k and v of its own heads side by side: of
    JAX's (L, D, 3D) leaf, the columns [j*D + m*D/tp, j*D + (m+1)*D/tp)
    for j = q, k, v — not JAX's contiguous block [m*3D/tp, (m+1)*3D/tp)."""
    m = _model("tiny", n_head=4).init(torch.Generator().manual_seed(1))
    lay = TP.TPLayout(m, tp, 1)
    d = m.config.n_embd
    w, b = m.param_dict()["h.attn.qkv.w"], m.param_dict()["h.attn.qkv.b"]
    for r in range(tp):
        cols = torch.cat([torch.arange(j * d + r * d // tp,
                                       j * d + (r + 1) * d // tp)
                          for j in range(3)])
        got = lay.shard("h.attn.qkv.w", w, {"model": r, "expert": 0})
        assert torch.equal(got, w[..., cols])
        assert torch.equal(lay.shard("h.attn.qkv.b", b,
                                     {"model": r, "expert": 0}), b[..., cols])
        jax_block = w[..., r * 3 * d // tp:(r + 1) * 3 * d // tp]
        assert not torch.equal(got, jax_block)


def test_cuts_are_jax_rules():
    """The port's tables are JAX's, leaf for leaf, and the layout cuts
    exactly the leaves they name."""
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    for preset in ("tiny", "llama-tiny", "moe-tiny"):
        pm, jm = _model(preset), jbuild(JP[preset])
        assert pm.tp_rules() == jm.tp_rules(), preset
        assert (getattr(pm, "ep_rules", dict)()
                == getattr(jm, "ep_rules", dict)()), preset
        lay = TP.TPLayout(pm, 2, 2 if preset == "moe-tiny" else 1)
        cut = {n: [(c.dim, c.axis) for c in cs]
               for n, cs in lay.cuts.items() if cs}
        want = {n: [(d, "model")] for n, d in jm.tp_rules().items()}
        for n, d in getattr(jm, "ep_rules", dict)().items():
            want.setdefault(n, []).append((d, "expert"))
        assert cut == want, preset
    lay = TP.TPLayout(_model("tiny", tie_weights=True), 2, 1)
    assert "lm_head.w" not in lay.cuts  # JAX skips absent names


def test_make_context_rank_order(world1):  # noqa: F811
    """The coordinates of a rank are JAX's mesh order, the last axis
    fastest: rank = ((d*SP + s)*TP + m)*EP + e."""
    p = make_context()
    assert (p.model_size, p.expert_size, p.model_group, p.expert_group,
            p.model_comm, p.tensor_parallel, p.expert_parallel) == (
        1, 1, None, None, None, False, False)
    q = _pctx(16, dp=2, sp=2, tp=2, ep=2)
    seen = {q.rank_of(d, s, m, e) for d in range(2) for s in range(2)
            for m in range(2) for e in range(2)}
    assert seen == set(range(16))
    assert q.rank_of(1, 0, 1, 0) == 10 and q.batch_ranks == 4


# -- refusals, against JAX's --------------------------------------------------


def _jax_error(name, preset, shape, names, model_kw=None, **kw):
    """The exception JAX's engine raises on a CPU mesh of `shape`, or
    None when it builds."""
    import jax
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    mesh = J.make_mesh(shape, names,
                       devices=jax.devices()[:int(np.prod(shape))])
    model = jbuild(dataclasses.replace(JP[preset], **(model_kw or {})))
    try:
        getattr(J, name)(model, J.AdamW(), mesh=mesh, **kw)
    except Exception as e:
        return e
    return None


def _port_error(name, preset, pctx, model_kw=None, **kw):
    try:
        getattr(T, name)(_model(preset, **(model_kw or {})), T.AdamW(),
                         device="cpu", pctx=pctx, **kw)
    except Exception as e:
        return e
    return None


REFUSALS = {
    "n_head": ("DDP", "tiny", dict(n_head=1), (1, 2), ("data", "model"),
               {}, dict(tp=2)),
    "leaf-dim-model": ("DDP", "tiny", dict(vocab_size=511), (1, 2),
                       ("data", "model"), {}, dict(tp=2)),
    "leaf-dim-expert": ("DDP", "moe-tiny", dict(n_expert=3), (1, 2),
                        ("data", "expert"), {}, dict(ep=2)),
    "ulysses-local-heads": ("Zero2", "tiny", None, (1, 2, 2),
                            ("data", "seq", "model"),
                            dict(seq_impl="ulysses"),
                            dict(sp=2, tp=2, impl="ulysses")),
    "grad-slot-model": ("Zero2", "tiny", None, (2, 2), ("data", "model"),
                        dict(grad_buckets=2), dict(dp=2, tp=2)),
    "grad-codec-expert": ("Zero2", "moe-tiny", None, (2, 2),
                          ("data", "expert"), dict(grad_comm="int8"),
                          dict(dp=2, ep=2)),
    "gather-slot-expert": ("Zero3", "moe-tiny", None, (2, 2),
                           ("data", "expert"), dict(gather_prefetch=2),
                           dict(dp=2, ep=2)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusal_is_jaxs(case):
    name, preset, mkw, shape, names, kw, lay = REFUSALS[case]
    want = _jax_error(name, preset, shape, names, mkw, **kw)
    assert want is not None, case
    got = _port_error(name, preset, _pctx(int(np.prod(shape)), **lay), mkw,
                      **kw)
    assert type(got) is type(want) and str(got) == str(want), (got, want)


def test_device_count_refusal_is_jaxs(world1, monkeypatch):  # noqa: F811
    """tensor_parallel=2 at world 1: JAX's message (its device count
    made 1)."""
    import jax
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    for kw in (dict(tensor_parallel=2), dict(expert_parallel=2),
               dict(tensor_parallel=2, expert_parallel=3)):
        with pytest.raises(ValueError) as want:
            J.DDP(jbuild(JP["moe-tiny"]), J.AdamW(), **kw)
        with pytest.raises(ValueError) as got:
            T.DDP(_model("moe-tiny"), T.AdamW(), device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_port_only_refusals():
    """Pipeline parallelism names the next slice; K/V heads the model
    axis does not divide are refused where JAX's engine builds (GSPMD
    splits k.w's columns mid-head; the port cuts whole heads: ROADMAP.md,
    known differences); a given context that carries another split."""
    with pytest.raises(ValueError, match=r"\['pipeline_parallel'\].*slice 25"):
        T.Zero2(_model("tiny"), T.AdamW(), device="cpu", pctx=_pctx(2, dp=2),
                pipeline_parallel=2)
    assert _jax_error("DDP", "llama-tiny", (1, 4), ("data", "model")) is None
    got = _port_error("DDP", "llama-tiny", _pctx(4, tp=4))
    assert isinstance(got, ValueError)
    assert str(got).startswith("n_kv_head=2 not divisible by "
                               "tensor-parallel axis size 4")
    with pytest.raises(ValueError, match="disagrees with the given pctx"):
        T.DDP(_model("tiny"), T.AdamW(), device="cpu", pctx=_pctx(4, tp=4),
              tensor_parallel=2)
    with pytest.raises(ValueError, match="need a distributed engine"):
        T.SingleDevice(_model("tiny"), T.AdamW(), device="cpu",
                       tensor_parallel=2)


# -- the collectives and the vocab-parallel head ------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_copy_to_and_reduce_from(n):
    """f: forward identity, backward the group's SUM; g: forward SUM,
    backward identity — through `lockstep`."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 5, generator=gen)
    ws = [torch.randn(5, 5, generator=gen) for _ in range(n)]
    xs = [x.clone().requires_grad_() for _ in range(n)]

    def rank(comm):
        r = comm.rank
        return C.reduce_from(C.copy_to(xs[r], comm) @ ws[r], comm)

    outs = OP.lockstep(n, rank)
    want = sum(x @ w for w in ws)
    for o in outs:
        torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-6)
    # the backward's SUM over the group: each rank's own pass
    gs = OP.lockstep(n, lambda comm: torch.autograd.grad(
        C.copy_to(xs[comm.rank], comm) @ ws[comm.rank],
        xs[comm.rank], torch.ones(3, 5))[0])
    for g in gs:
        torch.testing.assert_close(g, sum(torch.ones(3, 5) @ w.t()
                                          for w in ws), rtol=1e-6, atol=1e-6)


def test_lockstep_groups_reduce_over_their_members():
    """A (model 2 x expert 2) layout in one process: each rank's model
    group sums over the ranks of its expert index, its expert group over
    those of its model index, the whole group over all four; a MAX too;
    `known` makes a second call one pass."""
    xs = [torch.full((2,), float(10 ** r)) for r in range(4)]

    def rank(comm):
        m, e = divmod(comm.rank, 2)
        mg, eg = comm.group([e, 2 + e]), comm.group([2 * m, 2 * m + 1])
        assert (mg.rank, mg.size, eg.rank, eg.size) == (m, 2, e, 2)
        return (mg.all_reduce(xs[comm.rank]), eg.all_reduce(xs[comm.rank]),
                comm.all_reduce(xs[comm.rank], "max"), comm.calls)

    known = []
    outs = OP.lockstep(4, rank, known)
    for r, (mo, eo, mx, calls) in enumerate(outs):
        m, e = divmod(r, 2)
        assert mo[0] == 10 ** e + 10 ** (2 + e)
        assert eo[0] == 10 ** (2 * m) + 10 ** (2 * m + 1)
        assert mx[0] == 1000 and calls == 3
    assert len(known) == 3
    seen = []
    OP.lockstep(4, lambda comm: seen.append(comm.rank), known)
    assert seen == [0, 1, 2, 3]


def _noisy_block_params(m, seed):
    """Layer 0's block params, every bias drawn non-zero."""
    gen = torch.Generator().manual_seed(seed)
    bp = {}
    for k, v in m.stacked_compute_params().items():
        v = v[0].detach().clone()
        if k.endswith(".b"):
            v += 0.1 * torch.randn(v.shape, generator=gen)
        bp[k] = v
    return bp


@pytest.mark.parametrize("preset,tp,ep", [
    ("tiny", 2, 1), ("tiny", 4, 1), ("llama-tiny", 2, 1),
    ("moe-tiny", 1, 2), ("moe-tiny", 2, 2)])
def test_block_through_lockstep_equals_whole(preset, tp, ep):
    """The model's own block (`_block_fn`: remat, both dropout sites)
    with non-zero biases, every rank holding its pieces and its own
    copies of the replicated leaves, run through `lockstep` (true
    all-reduces forward, in the recompute and backward): every rank's
    output and the gradients of its input and of every leaf equal the
    whole block's, a piece's cut from the whole's, within 1e-5 (chip
    phase 17a / 17c's harness, at the CPU's f32)."""
    kw = dict(dropout=0.1) if preset == "llama-tiny" else dict(
        dropout=0.1, n_head=4)
    m = _model(preset, **kw).init(torch.Generator().manual_seed(1))
    bp = _noisy_block_params(m, 2)
    lay = TP.TPLayout(m, tp, ep)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, m.config.n_embd, generator=gen)
    gout = torch.randn(2, 32, m.config.n_embd, generator=gen)
    moe = preset == "moe-tiny"
    gouts = (gout, torch.ones(())) if moe else (gout,)
    keys = list(bp)
    block = m._block_fn()

    def run(leaves, pctx):
        out = block(leaves[0], dict(zip(keys, leaves[1:])), dkey=7,
                    pctx=pctx)
        outs = out if moe else (out,)
        return ([o.detach() for o in outs],
                torch.autograd.grad(outs, leaves, gouts))

    def piece(k, t, mr, er):
        return lay.shard("h." + k, t[None], {"model": mr, "expert": er})[0]

    def leaves(cut):
        return [x.clone().requires_grad_()] + [
            cut(k, bp[k]).clone().requires_grad_() for k in keys]

    want = run(leaves(lambda k, t: t), None)

    def rank(comm):
        mr, er = divmod(comm.rank, ep)

        def group(members):
            return comm.group(members) if len(members) > 1 else None
        ctx = ParallelContext(
            world=1, rank=0, data_size=1, seq_size=1, data_rank=0,
            seq_rank=0, model_size=tp, expert_size=ep, model_rank=mr,
            expert_rank=er, model_comm=group([k * ep + er
                                              for k in range(tp)]),
            expert_comm=group([mr * ep + k for k in range(ep)]),
            mxe_comm=group(range(tp * ep)) if tp > 1 and ep > 1 else None)
        return run(leaves(lambda k, t: piece(k, t, mr, er)), ctx)

    for r, (outs, grads) in enumerate(OP.lockstep(tp * ep, rank)):
        mr, er = divmod(r, ep)
        for o, w in zip(outs, want[0]):
            torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(grads[0], want[1][0], rtol=1e-5,
                                   atol=1e-5)
        for k, g, w in zip(keys, grads[1:], want[1][1:]):
            torch.testing.assert_close(
                g, piece(k, w, mr, er), rtol=1e-5, atol=1e-5,
                msg=lambda s, k=k: f"{k}: {s}")


def _head_inputs(seed=3, b=2, t=64, d=32, v=96):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, d, generator=gen)
    w = torch.randn(d, v, generator=gen) * 0.2
    y = torch.randint(0, v, (b, t), generator=gen)
    return x, w, y


def _whole_head(fn, x, w, y):
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    loss = fn(x, w, y)
    loss.backward()
    return loss.detach(), x.grad, w.grad


@pytest.mark.parametrize("impl,fp8", [("chunked", "off"), ("chunked", "on"),
                                      ("unfused", "off")])
@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_head_equals_whole(n, impl, fp8):
    """The rank's (D, V/n) columns: the loss is the whole head's on every
    rank, and the ranks' dx partials (summed, as copy_to's backward sums
    them) and dW column blocks are the whole head's, within 1e-6 (fp8
    products run in the chunked head only)."""
    x, w, y = _head_inputs()
    v = w.shape[1]
    if impl == "chunked":
        def head(xx, ww, yy, vocab=None):
            return X.fused_linear_xent(xx, ww, yy, vocab=vocab)
    else:
        def head(xx, ww, yy, vocab=None):
            return X.softmax_cross_entropy(xx @ ww, yy, vocab=vocab)
    fp8_mod.set_fp8_matmul(fp8)
    try:
        want = _whole_head(head, x, w, y)
        xs = x.clone().requires_grad_()
        ws = [w[:, r * v // n:(r + 1) * v // n].clone().requires_grad_()
              for r in range(n)]
        losses = OP.lockstep(n, lambda comm: head(
            xs, ws[comm.rank], y, vocab=(comm, comm.rank * v // n)))
        sum(losses).backward()
    finally:
        fp8_mod.set_fp8_matmul("off")
    for loss in losses:
        torch.testing.assert_close(loss.detach(), want[0], rtol=1e-6,
                                   atol=1e-6)
    torch.testing.assert_close(xs.grad, want[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([g.grad for g in ws], 1), want[2],
                               rtol=1e-6, atol=1e-6)


class _Counting(OP.LocalReduce):
    """A shard's communicator that logs each all-reduce's group and
    bytes."""

    def __init__(self, rank, size, log, group):
        super().__init__(rank, size)
        self.log, self.group = log, group

    def all_reduce(self, x, op="sum"):
        self.log.append((self.group, x.numel() * x.element_size()))
        return x


def _want_reduces(model, tp, ep, b, t):
    """The all-reduces one training step issues on a rank whose (b, t)
    block runs under a (model, expert) split of sizes (tp, ep): [(group,
    bytes)], one entry a call.  The activations' reduces move the compute
    dtype, the head's statistics and the router's gates f32.  Under remat
    a block's checkpoint replays its forward reduces, all but the last
    one whose output only feeds the residual add."""
    c = model.config
    rows, d = b * t, c.n_embd
    cd = torch.empty((), dtype=c.compute_dtype).element_size()
    remat = int(bool(c.remat) and c.remat_policy != "all")
    out = []

    def add(group, count, nbytes):
        out.extend([(group, nbytes)] * (count * c.n_layer))

    moe = getattr(c, "n_expert", None)
    if tp > 1:  # the attention: qkv column-, out row-parallel
        add("model", 2 + remat, rows * d * cd)
    if moe is None and tp > 1:  # the MLP's out feeds only the residual
        add("model", 2, rows * d * cd)
    if moe is not None:
        cap = model._capacity(rows)
        if tp > 1:  # the experts' out feeds the combine's product
            add("model", 1 + remat, moe // ep * cap * d * cd)
        if ep > 1:  # the combine; the gates
            add("expert", 1, rows * d * cd)
            add("expert", 1, rows * c.expert_top_k * 4)
        if tp > 1 or ep > 1:  # the panel's gradient
            add("model x expert" if tp > 1 and ep > 1
                else "model" if tp > 1 else "expert", 1, rows * d * cd)
    if tp > 1 and not c.tie_weights:  # the vocab-parallel head, once
        out += [("model", rows * 4), ("model", 2 * rows * 4),
                ("model", rows * d * cd)]
    return out


@pytest.mark.parametrize("policy", ["dots_no_batch", "nothing", "all"])
@pytest.mark.parametrize("preset,tp,ep", [
    ("tiny", 2, 1), ("tiny", 4, 1), ("llama-tiny", 2, 1),
    ("moe-tiny", 2, 1), ("moe-tiny", 1, 2), ("moe-tiny", 2, 2)])
def test_step_all_reduces_match_the_calls(preset, tp, ep, policy):
    """The all-reduces rank 0's shard issues in one forward + backward of
    the model (its communicators count) against the sites the layout
    implies: groups, sizes and counts, remat's replay included (5 a GPT-2
    layer under a checkpoint: the block's last reduce is not
    replayed)."""
    m = _model(preset, n_head=4, remat_policy=policy)
    if preset == "llama-tiny":
        m = _model(preset, remat_policy=policy)
    m.init(torch.Generator().manual_seed(0))
    lay = TP.TPLayout(m, tp, ep)
    params = {n: lay.shard(n, p.detach()).clone().requires_grad_()
              for n, p in m.param_dict().items()}
    log = []
    mk = (lambda n, g: _Counting(0, n, log, g) if n > 1 else None)
    ctx = dataclasses.replace(
        _pctx(1), model_size=tp, expert_size=ep, tp=lay,
        model_comm=mk(tp, "model"), expert_comm=mk(ep, "expert"),
        mxe_comm=mk(tp * ep if tp > 1 and ep > 1 else 1, "model x expert"))
    idx = torch.randint(0, 512, (2, 32), generator=torch.Generator())
    loss = m.apply(idx, idx, pctx=ctx, params=params)
    torch.autograd.grad(loss, list(params.values()))
    assert sorted(log) == sorted(_want_reduces(m, tp, ep, 2, 32))
    if preset == "tiny" and policy == "dots_no_batch":
        assert len(log) == 5 * m.config.n_layer + 3


def test_count_once():
    """A leaf cut over an axis is counted on every rank of it, a
    replicated one on that axis's rank 0 only."""
    m = _model("moe-tiny")
    lay = TP.TPLayout(m, 2, 2)
    for mr in range(2):
        for er in range(2):
            p = dataclasses.replace(_pctx(4, tp=2, ep=2), model_rank=mr,
                                    expert_rank=er, tp=lay)
            assert TP.count_once(p, "wte") == (mr == 0 and er == 0)
            assert TP.count_once(p, "h.attn.qkv.w") == (er == 0)
            assert TP.count_once(p, "h.moe.proj.b") == (mr == 0)
            assert TP.count_once(p, "h.moe.fc.w")
    assert TP.count_once(_pctx(2, dp=2), "wte")


@pytest.mark.parametrize("tp,ep,want", [(1, 1, "sort"), (2, 1, "einsum"),
                                        (1, 2, "einsum")])
def test_effective_dispatch_under_ep_tp(tp, ep, want):
    """JAX's predicate (moe.py:73-84): "sort" falls back to "einsum"
    under expert or tensor parallelism."""
    cfg = dataclasses.replace(T.ALL_PRESETS["moe-tiny"], moe_dispatch="sort")
    assert moe_mod.effective_dispatch(cfg, _pctx(2 if tp * ep == 1 else
                                                 tp * ep, dp=2 // (tp * ep)
                                                 or 1, tp=tp, ep=ep)) == want


# -- the training entry -------------------------------------------------------


def test_train_refuses_splits_on_one_device():
    from tiny_deepspeed_tpu_torch import train
    for flag in ("--tensor-parallel", "--expert-parallel",
                 "--pipeline-parallel"):
        with pytest.raises(SystemExit, match=f"{flag} needs a distributed"):
            train.main(["--device", "cpu", "--model", "tiny", "--iters", "1",
                        flag, "2"])


def test_train_refuses_pipeline_parallel():
    import torch.distributed as dist
    from tiny_deepspeed_tpu_torch import train
    try:
        with pytest.raises(ValueError, match="slice 25"):
            train.main(["--device", "cpu", "--model", "tiny", "--iters",
                        "1", "--engine", "ddp", "--pipeline-parallel", "2"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_torchrun_zero2_tp2_on_cpu():
    """Four gloo ranks under torchrun, data 2 x tp 2: rank 0 prints the
    JAX CLI's lines."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "tiny_deepspeed_tpu_torch.train",
         "--device", "cpu", "--model", "tiny", "--engine", "zero2",
         "--tensor-parallel", "2", "--iters", "2", "--seq-len", "64"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("Zero2(stage=2, devices=4, accum=1")
    assert lines[1] == "model=tiny params=0.2M global_batch=4 T=64"
    assert [ln.split()[:2] for ln in lines if " loss " in ln] == [
        ["iter", "0"], ["iter", "1"]]
    assert lines[-1].startswith("done: 2 iters in ")
