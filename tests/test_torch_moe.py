# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's MoE family against the JAX package's, on the CPU.

The JAX package's MoE test config (tests/test_moe.py: 2 layers, 4 heads,
n_embd 32, vocab 128, 4 experts, top-2, f32) is initialised by the JAX
model from a seed and its weights cross to the port through
`convert.params_from_numpy`; token ids come from numpy.  Pinned here:

- `param_shapes`: JAX's init names, shapes and insertion order, also
  with `bias=False` and `tie_weights`; moe-8x124m's 559,867,392;
- the router's expert choices equal JAX's, its gates within 1e-6
  (absolute: the f32 logits' products and softmax round apart by an
  ulp) and its aux within 1e-6 relative; the einsum dispatch table and
  the sort path's src table equal JAX's exactly, the gate-valued tables
  (einsum combine, sort gate) within 1e-6, under capacity and under
  overflow (`capacity_factor` 0.5: the two dispatches drop different
  tokens, each JAX's own); the einsum tables cast to bf16 within one
  bf16 step of JAX's f32 tables cast;
- ties: a zero router picks experts 0 and 1, as `jax.lax.top_k` does;
- the loss (1e-5 relative) and every gradient (max abs error within
  1e-5 of the leaf's max |gradient|) against `jax.value_and_grad`, for
  both dispatches, under overflow and at ties;
- remat on and off bit for bit, for both dispatches;
- with bf16 compute: the stacked router f32 under SingleDevice and under
  ZeRO-3's `prepare`, the other block leaves bf16, the fp8 gather leaving
  the router out and scaling the expert leaves per (layer, out-channel)
  bit for bit JAX's; the loss within 2e-2 relative of JAX's bf16 loss;
- `effective_dispatch` equal to JAX's for every rank layout the port
  builds, an unknown dispatch refused;
- the serving engine refuses MoEGPT; `build_model`, `ALL_PRESETS` and
  `train --model moe-tiny --moe-dispatch sort` know the family.

The training trajectories are in tests/test_torch_moe_train.py, the
engines over gloo in tests/test_torch_moe_dist.py.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.models import moe as JM
from tiny_deepspeed_tpu.parallel.mesh import ParallelContext as JPC
from tiny_deepspeed_tpu.parallel.mesh import make_mesh
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import moe as TM
from tiny_deepspeed_tpu_torch.parallel.mesh import ParallelContext
from test_torch_dist import world1  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(block_size=32, vocab_size=128, n_layer=2, n_head=4, n_embd=32,
            n_expert=4, expert_top_k=2)
OVERFLOW = dict(capacity_factor=0.5)


def configs(dtype="f32", **overrides):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    kw = dict(_CFG, **overrides)
    return (JM.MoEConfig(compute_dtype=jd, **kw),
            TM.MoEConfig(compute_dtype=td, **kw))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def pair(dtype="f32", **overrides):
    """(jax model, jax params, port model) with the same weights."""
    jcfg, tcfg = configs(dtype, **overrides)
    jm = JM.MoEGPT(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.MoEGPT(tcfg, device="cpu")
    pm.load_state_dict(T.params_from_numpy(_np(jp), "cpu"))
    return jm, jp, pm


def _tokens(seed, b=4, t=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 128, (b, t)).astype(np.int32),
            rng.integers(0, 128, (b, t)).astype(np.int32))


def _router_in(seed, s=64, d=32, e=4, zero=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, d)).astype(np.float32)
    w = (np.zeros((d, e)) if zero
         else 0.5 * rng.standard_normal((d, e))).astype(np.float32)
    return x, w


def _t(a):
    return torch.from_numpy(np.array(a))


# -- parameters ---------------------------------------------------------------

@pytest.mark.parametrize("over", [{}, dict(bias=False), dict(tie_weights=True),
                                  dict(bias=False, tie_weights=True)],
                         ids=["default", "no-bias", "tied", "no-bias-tied"])
def test_param_shapes_match_jax_init(over):
    jcfg, tcfg = configs(**over)
    jp = JM.MoEGPT(jcfg).init(jax.random.PRNGKey(0))
    got = T.MoEGPT.param_shapes(types.SimpleNamespace(config=tcfg))
    assert list(got) == list(jp)
    assert got == {k: tuple(v.shape) for k, v in jp.items()}


def test_moe_8x124m_param_count():
    cfg = T.MOE_PRESETS["moe-8x124m"]
    shapes = jax.eval_shape(JM.MoEGPT(JM.MOE_PRESETS["moe-8x124m"]).init,
                            jax.random.PRNGKey(0))
    got = T.MoEGPT.param_shapes(types.SimpleNamespace(config=cfg))
    assert got == {k: tuple(v.shape) for k, v in shapes.items()}
    assert sum(int(np.prod(s)) for s in got.values()) == 559_867_392
    for name in ("n_expert", "expert_top_k", "capacity_factor",
                 "aux_loss_weight", "ff_mult", "moe_dispatch", "n_layer",
                 "n_head", "n_embd", "vocab_size", "block_size"):
        for preset in T.MOE_PRESETS:
            assert (getattr(T.MOE_PRESETS[preset], name)
                    == getattr(JM.MOE_PRESETS[preset], name)), (preset, name)


# -- the router and the tables ------------------------------------------------

@pytest.mark.parametrize("zero", [False, True], ids=["random", "ties"])
def test_router_matches_jax(zero):
    jm, _, pm = pair()
    x, w = _router_in(1, zero=zero)
    jg, ji, jaux = jm._router(jnp.asarray(x), jnp.asarray(w))
    g, i, probs = pm._router(_t(x), _t(w))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    first = torch.bincount(i[:, 0], minlength=4)
    np.testing.assert_allclose(float(pm._aux(probs, first, x.shape[0])),
                               float(jaux), rtol=1e-6)
    if zero:  # every probability equal: the lowest two expert indices
        assert (i == torch.tensor([0, 1])).all()


@pytest.mark.parametrize("over", [{}, OVERFLOW], ids=["capacity", "overflow"])
def test_route_tables_match_jax(over):
    jm, _, pm = pair(**over)
    x, w = _router_in(2)
    jd, jc, jaux = jm._route(jnp.asarray(x), jnp.asarray(w))
    d, c, aux = pm._route(_t(x), _t(w))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the tables built in bf16 hold JAX's f32 tables cast (the gates
    # round; an ulp of f32 apart can land a bf16 step apart)
    db, cb, _ = pm._route(_t(x), _t(w), dtype=torch.bfloat16)
    np.testing.assert_array_equal(db.float().numpy(), np.asarray(jd))
    np.testing.assert_allclose(
        cb.float().numpy(),
        np.asarray(jc.astype(jnp.bfloat16).astype(jnp.float32)),
        atol=2 ** -8)
    if over:  # some choice was dropped
        assert float(jd.sum()) < x.shape[0] * 2


@pytest.mark.parametrize("over", [{}, OVERFLOW], ids=["capacity", "overflow"])
def test_route_sort_tables_match_jax(over):
    jm, _, pm = pair(**over)
    x, w = _router_in(3)
    jsrc, jgate, jaux = jm._route_sort(jnp.asarray(x), jnp.asarray(w))
    src, gate, aux, inv = pm._route_sort(_t(x), _t(w))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # inv is src's transpose: each kept (token, choice) names its slot
    s, n = x.shape[0], src.numel()
    for tok in range(s):
        slots = [int(v) for v in inv[tok] if v < n]
        assert sorted(slots) == sorted(
            np.flatnonzero(src.numpy() == tok).tolist())
    if over:
        assert int((inv == n).sum()) > 0


def test_overflow_dispatches_drop_different_tokens():
    """Under overflow the einsum path fills first choices first and the
    sort path token by token: the kept (token, expert) sets differ, and
    each path is its own JAX path's."""
    jm, _, _ = pair(**OVERFLOW)
    x, w = _router_in(2)
    jd, _, _ = jm._route(jnp.asarray(x), jnp.asarray(w))
    jsrc, _, _ = jm._route_sort(jnp.asarray(x), jnp.asarray(w))
    e, cap = jd.shape[1], jd.shape[2]
    kept_einsum = {(int(s), int(ec) // cap) for s, ec in
                   zip(*np.nonzero(np.asarray(jd).reshape(-1, e * cap)))}
    kept_sort = {(int(t), slot // cap) for slot, t in
                 enumerate(np.asarray(jsrc)) if t < x.shape[0]}
    assert kept_einsum != kept_sort


# -- the model ----------------------------------------------------------------

CASES = {"einsum": {}, "sort": dict(moe_dispatch="sort"),
         "einsum-overflow": OVERFLOW,
         "sort-overflow": dict(OVERFLOW, moe_dispatch="sort"),
         "einsum-ties": dict(zero_router=True),
         "sort-ties": dict(moe_dispatch="sort", zero_router=True)}


def _grads(pm, x, y):
    loss = pm.apply(_t(x).long(), _t(y).long())
    names = list(pm.param_dict())
    grads = torch.autograd.grad(loss, list(pm.param_dict().values()))
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    over = dict(CASES[case])
    zero = over.pop("zero_router", False)
    jm, jp, pm = pair(**over)
    if zero:
        jp = dict(jp, **{"h.moe.router.w": jnp.zeros_like(
            jp["h.moe.router.w"])})
        with torch.no_grad():
            pm.get_parameter("h.moe.router.w").zero_()
    x, y = _tokens(5)
    jl, jg = jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(x), jnp.asarray(y)))(jp)
    loss, grads = _grads(pm, x, y)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for n, g in grads.items():
        want = np.asarray(jg[n])
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (n, err)


@pytest.mark.parametrize("disp", ["einsum", "sort"])
def test_remat_on_off_bit_identical(disp):
    _, _, pm = pair(moe_dispatch=disp, remat_policy="nothing")
    x, y = _tokens(6)
    on = _grads(pm, x, y)
    pm.config = dataclasses.replace(pm.config, remat=False)
    off = _grads(pm, x, y)
    assert torch.equal(on[0], off[0])
    for n, g in on[1].items():
        assert torch.equal(g, off[1][n]), n


# -- bf16 compute: the router stays f32 ---------------------------------------

def test_bf16_stacked_router_stays_f32(world1):
    _, tcfg = configs("bf16")
    pm = T.MoEGPT(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    stacked = pm.stacked_compute_params()
    assert stacked["moe.router.w"].dtype == torch.float32
    assert {v.dtype for k, v in stacked.items()
            if k != "moe.router.w"} == {torch.bfloat16}
    eng = T.Zero3(T.MoEGPT(tcfg, device="cpu"), T.AdamW(lr=1e-3),
                  device="cpu")
    state = eng.init(0)
    _, zst = eng._z3.prepare(state.params)
    assert zst["moe.router.w"].dtype == torch.float32
    assert {v.dtype for k, v in zst.items()
            if k != "moe.router.w"} == {torch.bfloat16}


def test_fp8_gather_leaves_router_out_and_matches_jax(world1):
    """Router in f32, expert leaves as e4m3 codes with (L, 1, 1, out)
    scales: bit for bit JAX's `stacked_compute_params`, on one device and
    from ZeRO-3's shards."""
    jm, jp, pm = pair("bf16", gather_quant="fp8")
    want = jm.stacked_compute_params(jp)
    got = pm.stacked_compute_params()
    assert "moe.router.w#scale" not in got
    assert got["moe.router.w"].dtype == torch.float32
    eng = T.Zero3(T.MoEGPT(pm.config, device="cpu"), T.AdamW(lr=1e-3),
                  device="cpu")
    state = eng.init(0)
    eng.load_params(state, pm.param_dict())
    _, zst = eng._z3.prepare(state.params)
    for name in ("moe.fc.w", "moe.proj.w", "attn.qkv.w"):
        ws = np.asarray(want[name + "#scale"])
        for st in (got, zst):
            assert tuple(st[name + "#scale"].shape) == ws.shape, name
            np.testing.assert_array_equal(st[name + "#scale"].numpy(), ws)
        codes = np.asarray(want[name].astype(jnp.float32))
        np.testing.assert_array_equal(got[name].float().numpy(), codes)
        np.testing.assert_array_equal(
            zst[name].view(torch.float8_e4m3fn).float().numpy().reshape(
                codes.shape), codes)


@pytest.mark.parametrize("disp", ["einsum", "sort"])
def test_bf16_loss_matches_jax(disp):
    jm, jp, pm = pair("bf16", moe_dispatch=disp)
    x, y = _tokens(7)
    jl = float(jm.apply(jp, jnp.asarray(x), jnp.asarray(y)))
    loss = float(pm.apply(_t(x).long(), _t(y).long()))
    np.testing.assert_allclose(loss, jl, rtol=2e-2)


# -- dispatch selection, refusals, entry points -------------------------------

@pytest.mark.parametrize("layout", [None, (1, 1), (2, 1), (4, 1), (1, 2),
                                    (2, 2)],
                         ids=["none", "world1", "data2", "data4", "seq2",
                              "data2-seq2"])
@pytest.mark.parametrize("disp", ["einsum", "sort"])
def test_effective_dispatch_matches_jax(layout, disp):
    jcfg, tcfg = configs(moe_dispatch=disp)
    jpctx = pctx = None
    if layout is not None:
        dp, sp = layout
        jpctx = JPC(make_mesh((dp, sp), ("data", "seq"),
                              devices=jax.devices()[:dp * sp]),
                    data_axis="data", seq_axis="seq")
        pctx = ParallelContext(world=dp * sp, rank=0, data_size=dp,
                               seq_size=sp, data_rank=0, seq_rank=0)
    assert (TM.effective_dispatch(tcfg, pctx)
            == JM.effective_dispatch(jcfg, jpctx))


def test_unknown_dispatch_refused():
    with pytest.raises(ValueError, match="moe_dispatch"):
        T.MoEGPT(configs(moe_dispatch="scatter")[1], device="cpu")


def test_serving_engine_refuses_moe():
    _, tcfg = configs()
    with pytest.raises(ValueError, match="paged decode"):
        T.ServingEngine(T.MoEGPT(tcfg, device="cpu"),
                        T.ServeConfig(max_active=2, num_blocks=16,
                                      block_tokens=8), device="cpu")


def test_build_model_knows_moe():
    assert {"moe-tiny", "moe-8x124m"} <= set(T.ALL_PRESETS)
    m = T.build_model("moe-tiny", device="cpu")
    assert type(m) is T.MoEGPT and m.config == T.MOE_PRESETS["moe-tiny"]
    cfg = dataclasses.replace(T.MOE_PRESETS["moe-tiny"], moe_dispatch="sort")
    assert T.build_model(cfg, device="cpu").config.moe_dispatch == "sort"


def test_train_module_runs_moe_tiny_sort():
    out = subprocess.run(
        [sys.executable, "-m", "tiny_deepspeed_tpu_torch.train",
         "--device", "cpu", "--model", "moe-tiny", "--moe-dispatch", "sort",
         "--iters", "3", "--seq-len", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("SingleDevice")
    assert lines[1] == "model=moe-tiny params=0.4M global_batch=1 T=32"
    assert [ln.split()[:2] for ln in lines if " loss " in ln] == [
        ["iter", "0"], ["iter", "1"], ["iter", "2"]]
    assert lines[-1].startswith("done: 3 iters in ")
    bad = subprocess.run(
        [sys.executable, "-m", "tiny_deepspeed_tpu_torch.train",
         "--device", "cpu", "--model", "tiny", "--moe-dispatch", "sort",
         "--iters", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=240)
    assert bad.returncode != 0 and "no moe_dispatch knob" in bad.stderr
