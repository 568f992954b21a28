# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's Llama family against the JAX package's, on the CPU.

Two tiny f32 configs: the JAX package's test config (tests/test_llama.py:
2 layers, 4 query heads over 2 kv heads, n_embd 32, vocab 128; group 2)
and a group-3 variant (6 heads over 2, n_embd 48).  Inputs are made with
numpy from a seed; weights cross through `convert.params_from_numpy`.
Pinned here:

- RMSNorm's plain forward, dx and dw against JAX `rmsnorm_fwd` /
  `rmsnorm_dx` / `rmsnorm_dw` (1e-6), the add variant's sum bit for bit
  `x + r`, the autograd Functions' gradients against JAX's custom_vjp,
  the wrappers' routing to the C entries (`rms_fwd`, `rms_bwd`) on CUDA
  tensors, their refusals, and the ctypes argtypes against the entries;
- RoPE's angles and `rope` / `rope_at` / `rope_span` against JAX (1e-6);
- `param_shapes` names and order equal to JAX `LlamaModel.init`, and
  `build_model` / `ALL_PRESETS` over both families;
- the forward loss (1e-5) and every gradient (1e-4), remat on and off
  bit-identical, and the fp8 gather's quantized leaves.

The training trajectories are in tests/test_torch_llama_train.py.
"""

import ctypes
import dataclasses
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.models import llama as JL
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import llama as TL
from tiny_deepspeed_tpu_torch.ops import _build, rmsnorm

# the module (the package re-exports the function under the same name)
JR = importlib.import_module("tiny_deepspeed_tpu.ops.rmsnorm")
CSRC = _build.CSRC
TOL6 = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)

# (JAX config, port config) of the two tiny models: groups 2 and 3
_WIDTHS = {"g2": dict(n_head=4, n_kv_head=2, n_embd=32),
           "g3": dict(n_head=6, n_kv_head=2, n_embd=48)}


def configs(name, block_size=32, **overrides):
    kw = dict(block_size=block_size, vocab_size=128, n_layer=2,
              **_WIDTHS[name], **overrides)
    return (JL.LlamaConfig(compute_dtype=jnp.float32, **kw),
            TL.LlamaConfig(compute_dtype=torch.float32, **kw))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def pair(name, **overrides):
    """(jax model, jax params, port model) with the same weights."""
    jcfg, tcfg = configs(name, **overrides)
    jm = JL.LlamaModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.LlamaModel(tcfg, device="cpu")
    pm.load_state_dict(T.params_from_numpy(_np(jp), "cpu"))
    return jm, jp, pm


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(rows, n, seed):
    rng = np.random.default_rng(seed)
    x, r, gy, gs = (rng.standard_normal((rows, n)).astype(np.float32)
                    for _ in range(4))
    w = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, r, gy, gs, w


# -- RMSNorm ------------------------------------------------------------------

@pytest.mark.parametrize("rows,n", [(1, 8), (7, 48), (64, 96), (130, 770)])
def test_rmsnorm_plain_matches_jax(rows, n):
    x, _, gy, _, w = _operands(rows, n, rows * 1000 + n)
    jy, jrstd = JR.rmsnorm_fwd(jnp.asarray(x), jnp.asarray(w))
    y, rstd = rmsnorm.rmsnorm_fwd(_t(x), _t(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), **TOL6)
    jdx = JR.rmsnorm_dx(jnp.asarray(gy), jnp.asarray(x), jnp.asarray(w),
                        jrstd)
    jdw = JR.rmsnorm_dw(jnp.asarray(gy), jnp.asarray(x), jrstd)
    dx, dw = rmsnorm.rmsnorm_bwd(_t(gy), _t(x), _t(w), rstd)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw),
                               atol=1e-6 * rows, rtol=1e-6)


@pytest.mark.parametrize("rows,n", [(8, 768), (40, 96), (7, 770)])
def test_add_rmsnorm_matches_jax(rows, n):
    """s = x + r bit for bit, and the norm of s as JAX adds then norms."""
    x, r, *_, w = _operands(rows, n, rows + n)
    js = jnp.asarray(x) + jnp.asarray(r)
    jy, jrstd = JR.rmsnorm_fwd(js, jnp.asarray(w))
    s, y, rstd = rmsnorm.add_rmsnorm_fwd(_t(x), _t(r), _t(w))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(s.numpy(), (_t(x) + _t(r)).numpy())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), **TOL6)


@pytest.mark.parametrize("add", [False, True], ids=["rmsnorm", "add"])
def test_autograd_matches_jax_vjp(add):
    """RMSNormFn / AddRMSNormFn's gradients against jax.vjp of the JAX
    custom_vjp (the add: of x + r, both inputs taking s's gradient)."""
    x, r, gy, gs, w = _operands(12, 40, 11)
    jx, jr, jw = (jnp.asarray(a) for a in (x, r, w))
    tx, tr, tw = (_t(a).requires_grad_() for a in (x, r, w))
    if add:
        def f(a, b, c):
            s = a + b
            return s, JR.rmsnorm(s, c)
        (js, jy), vjp = jax.vjp(f, jx, jr, jw)
        want = vjp((jnp.asarray(gs), jnp.asarray(gy)))
        s, y = rmsnorm.add_rmsnorm(tx, tr, tw)
        got = torch.autograd.grad((s, y), (tx, tr, tw), (_t(gs), _t(gy)))
        np.testing.assert_array_equal(s.detach().numpy(), np.asarray(js))
    else:
        jy, vjp = jax.vjp(JR.rmsnorm, jx, jw)
        want = vjp(jnp.asarray(gy))
        y = rmsnorm.rmsnorm(tx, tw)
        got = torch.autograd.grad(y, (tx, tw), _t(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL6)
    for g, jg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-6,
                                   rtol=1e-5)


def test_rmsnorm_half_dtypes_round_like_jax():
    """bf16 inputs with an f32 weight: y and dx in bf16, dw in w's dtype,
    within a bf16 ulp of JAX."""
    x, _, gy, _, w = _operands(16, 64, 5)
    jx, jgy = (jnp.asarray(a, jnp.bfloat16) for a in (x, gy))
    jy, jrstd = JR.rmsnorm_fwd(jx, jnp.asarray(w))
    tx, tgy = (_t(a).to(torch.bfloat16) for a in (x, gy))
    y, rstd = rmsnorm.rmsnorm_fwd(tx, _t(w))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    dx, dw = rmsnorm.rmsnorm_bwd(tgy, tx, _t(w), rstd)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    jdx = JR.rmsnorm_dx(jgy, jx, jnp.asarray(w), jrstd)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def _bad_operands():
    x = torch.zeros(4, 8)
    w = torch.ones(8)
    return {
        "f64": ((x.double(), w), "f32/bf16/f16"),
        "int": ((x.int(), w), "f32/bf16/f16"),
        "n zero": ((torch.zeros(4, 0), torch.ones(0)),
                   r"not in \[1, 16384\]"),
        "n too wide": ((torch.zeros(1, 16385), torch.ones(16385)),
                       r"not in \[1, 16384\]"),
        "weight shape": ((x, torch.ones(7)), "weight"),
        "weight dtype": ((x, w.double()), "weight"),
        "cpu": ((x, w), "CUDA device"),
    }


@pytest.mark.parametrize("add", [False, True], ids=["fwd", "add"])
@pytest.mark.parametrize("case", list(_bad_operands()))
def test_cuda_forward_refuses_bad_operands(case, add):
    """Each check raises ValueError before anything is built (a build on
    this host, without nvcc, would raise RuntimeError)."""
    (x, w), match = _bad_operands()[case]
    with pytest.raises(ValueError, match=match):
        rmsnorm._fwd_cuda(x, x if add else None, w, 1e-5, "rmsnorm_fwd")


@pytest.mark.parametrize("case,match", [
    ("gy dtype", "share one of"), ("rstd shape", "rstd must be"),
    ("gs shape", "gs .* must match"), ("cpu", "CUDA device")])
def test_cuda_backward_refuses_bad_operands(case, match):
    x, w = torch.zeros(4, 8), torch.ones(8)
    gy, rstd, gs = torch.zeros(4, 8), torch.ones(4), None
    if case == "gy dtype":
        gy = gy.half()
    elif case == "rstd shape":
        rstd = torch.ones(5)
    elif case == "gs shape":
        gs = torch.zeros(4, 9)
    with pytest.raises(ValueError, match=match):
        rmsnorm._bwd_cuda(gy, x, w, rstd, gs)


def _counters():
    return (rmsnorm.rmsnorm_fwd, rmsnorm.add_rmsnorm_fwd,
            rmsnorm.rmsnorm_bwd)


def test_cpu_calls_count_no_launches():
    before = [f.launches for f in _counters()]
    x, r, _, _, w = (_t(a) for a in _operands(8, 64, 3))
    s, y = rmsnorm.add_rmsnorm(x.requires_grad_(), r, w)
    (s.sum() + rmsnorm.rmsnorm(y, w).sum()).backward()
    assert [f.launches for f in _counters()] == before


@pytest.mark.parametrize("entry", ["rmsnorm", "add_rmsnorm"])
def test_cuda_tensors_route_to_the_entries(entry, monkeypatch):
    """With `on_cuda` true, the autograd Functions call the C entries'
    wrappers once each way (`_fwd_cuda`, then `_bwd_cuda`, with gs for
    the add variant) and never the plain versions."""
    calls = []

    def fwd(x, r, w, eps, what):
        calls.append(("fwd", r is not None, what))
        return (None, *rmsnorm._rms_fwd_plain(x, w, eps)) if r is None \
            else rmsnorm._add_rms_fwd_plain(x, r, w, eps)

    def bwd(gy, x, w, rstd, gs=None, w_dtype=None):
        calls.append(("bwd", gs is not None))
        return rmsnorm._rms_bwd_plain(gy, x, w, rstd, gs, w_dtype)

    monkeypatch.setattr(rmsnorm, "on_cuda", lambda *t: True)
    monkeypatch.setattr(rmsnorm, "_fwd_cuda", fwd)
    monkeypatch.setattr(rmsnorm, "_bwd_cuda", bwd)
    for name in ("_rms_fwd_plain", "_add_rms_fwd_plain", "_rms_bwd_plain"):
        monkeypatch.setattr(rmsnorm, name, getattr(rmsnorm, name))
    x, r, _, _, w = (_t(a).requires_grad_() for a in _operands(6, 32, 5))
    if entry == "add_rmsnorm":
        s, y = rmsnorm.add_rmsnorm(x, r, w)
        (s.sum() + (y * y).sum()).backward()
        assert calls == [("fwd", True, "add_rmsnorm_fwd"), ("bwd", True)]
    else:
        (rmsnorm.rmsnorm(x, w) ** 2).sum().backward()
        assert calls == [("fwd", False, "rmsnorm_fwd"), ("bwd", False)]
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_longlong: "long long",
          ctypes.c_int: "int", ctypes.c_float: "float"}


def _c_params(source, name):
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"{name} not found in {source}"
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        kinds.append("pointer" if "*" in p else
                     "long long" if p.startswith("long long") else
                     p.split()[0])
    return kinds


@pytest.mark.parametrize("source,name,argtypes", [
    ("ln_fwd.cu", "rms_fwd", rmsnorm._FWD_ARGS),
    ("ln_bwd.cu", "rms_bwd", rmsnorm._BWD_ARGS)])
def test_ctypes_argtypes_match_the_c_entry(source, name, argtypes):
    assert [_KINDS[a] for a in argtypes] == _c_params(source, name)


# -- RoPE ---------------------------------------------------------------------

def test_rope_angles_match_jax():
    """cos / sin of the f32 angles theta ** (-i/half) * pos, against
    JAX's (the tables hold cos twice and (-sin, sin))."""
    dh, theta = 64, 10000.0
    pos = np.arange(0, 2048, 7)
    half = dh // 2
    freqs = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    ang = jnp.asarray(pos, jnp.float32)[:, None] * freqs[None, :]
    cos2, sin2 = TL.rope_tables(_t(pos), dh, theta)
    np.testing.assert_allclose(cos2[:, :half].numpy(), np.cos(ang), **TOL6)
    np.testing.assert_allclose(cos2[:, half:].numpy(), np.cos(ang), **TOL6)
    np.testing.assert_allclose(sin2[:, half:].numpy(), np.sin(ang), **TOL6)
    np.testing.assert_allclose(sin2[:, :half].numpy(), -np.sin(ang), **TOL6)


@pytest.mark.parametrize("dh", [8, 16, 64])
def test_rope_variants_match_jax(dh):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 3, 40, dh)).astype(np.float32)
    pos = np.arange(5, 45)
    np.testing.assert_allclose(
        TL.rope(_t(x), _t(pos), 1e4).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), **TOL6)
    xd = rng.standard_normal((5, 4, 1, dh)).astype(np.float32)
    pd = np.array([0, 3, 17, 255, 1023])
    np.testing.assert_allclose(
        TL.rope_at(_t(xd), _t(pd), 1e4).numpy(),
        np.asarray(JL.rope_at(jnp.asarray(xd), jnp.asarray(pd), 1e4)),
        **TOL6)
    xs = rng.standard_normal((3, 4, 5, dh)).astype(np.float32)
    ps = np.array([0, 9, 100])[:, None] + np.arange(5)[None, :]
    np.testing.assert_allclose(
        TL.rope_span(_t(xs), _t(ps), 1e4).numpy(),
        np.asarray(JL.rope_span(jnp.asarray(xs), jnp.asarray(ps), 1e4)),
        **TOL6)
    # a bf16 x rotates in f32 and is cast back once
    xb = _t(xs).to(torch.bfloat16)
    got = TL.rope_span(xb, _t(ps), 1e4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        TL.rope_span(xb.float(), _t(ps), 1e4).to(torch.bfloat16)
        .float().numpy())


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(_WIDTHS))
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_param_shapes_equal_jax_init(name, tied):
    jcfg, tcfg = configs(name, tie_weights=tied)
    jp = JL.LlamaModel(jcfg).init(jax.random.PRNGKey(0))
    shapes = T.LlamaModel(tcfg, device="cpu").param_shapes()
    assert list(shapes) == list(jp)
    assert {k: tuple(v.shape) for k, v in jp.items()} == shapes


def test_presets_and_build_model():
    import tiny_deepspeed_tpu.models as JM
    assert set(T.ALL_PRESETS) == set(JM.GPT2_PRESETS) | set(
        JM.LLAMA_PRESETS) | set(JM.MOE_PRESETS)
    for name, c in T.LLAMA_PRESETS.items():
        jc = JM.LLAMA_PRESETS[name]
        for f in ("block_size", "vocab_size", "n_layer", "n_head",
                  "n_embd", "kv_heads", "ffn", "rope_theta", "head_dim"):
            assert getattr(c, f) == getattr(jc, f), (name, f)
    m = T.build_model("llama-tiny", device="cpu")
    assert type(m) is T.LlamaModel
    assert type(T.build_model("tiny", device="cpu")) is T.GPT2Model
    c = T.ALL_PRESETS["llama-160m"]
    shapes = T.LlamaModel.param_shapes(type("M", (), {"config": c})())
    assert 150e6 < sum(int(np.prod(s)) for s in shapes.values()) < 156e6
    with pytest.raises(ValueError, match="multiple of n_kv_head"):
        T.LlamaModel(dataclasses.replace(c, n_kv_head=5), device="cpu")


def _batch(b=2, t=32, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, t)), rng.integers(0, vocab, (b, t))


def _loss_grads(pm, idx, tgt):
    loss = pm.apply(torch.from_numpy(idx), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    return float(loss.detach()), {n: g for (n, _), g in
                                  zip(pm.named_parameters(), grads)}


@pytest.mark.parametrize("name", list(_WIDTHS))
@pytest.mark.parametrize("overrides", [{}, dict(tie_weights=True)],
                         ids=["untied", "tied"])
def test_loss_and_grads_match_jax(name, overrides):
    jm, jp, pm = pair(name, **overrides)
    idx, tgt = _batch(t=32)
    jl, jg = jax.value_and_grad(jm.apply)(jp, jnp.asarray(idx),
                                          jnp.asarray(tgt))
    loss, grads = _loss_grads(pm, idx, tgt)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]),
                                   err_msg=n, **GRAD_TOL)


def test_logits_match_jax():
    """The graph-free forward's (B, 1, V) logits at a position."""
    jm, jp, pm = pair("g3")
    idx, _ = _batch(t=24, seed=4)
    want = jm.apply(jp, jnp.asarray(idx))
    got = pm.apply(torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy()[:, 0],
                               np.asarray(want)[:, -1], atol=1e-5,
                               rtol=1e-5)


def test_remat_policies_give_identical_grads():
    """RMSNormFn is recomputed under the selective policies, as
    LayerNormFn is: every policy gives the same bits."""
    idx, tgt = _batch(t=32, seed=1)
    ref = None
    for remat, policy in ((False, "dots_no_batch"), (True, "nothing"),
                          (True, "dots_no_batch"), (True, "dots"),
                          (True, "all")):
        _, _, pm = pair("g3", remat=remat, remat_policy=policy)
        loss, grads = _loss_grads(pm, idx, tgt)
        if ref is None:
            ref = (loss, grads)
            continue
        assert loss == ref[0]
        for n, g in grads.items():
            assert torch.equal(g, ref[1][n]), (policy, n)


def test_fp8_gather_quantizes_the_block_matmuls():
    """gather_quant="fp8" takes q/k/v/o/gate/up/down, never the norms."""
    _, tcfg = configs("g2", gather_quant="fp8")
    pm = T.LlamaModel(tcfg, device="cpu").init(torch.Generator()
                                                .manual_seed(0))
    st = pm.stacked_compute_params()
    assert sorted(k for k in st if k.endswith("#scale")) == sorted(
        f"{n}#scale" for n in ("attn.q.w", "attn.k.w", "attn.v.w",
                               "attn.o.w", "mlp.gate.w", "mlp.up.w",
                               "mlp.down.w"))
    idx, tgt = _batch(t=16)
    loss = pm.apply(torch.from_numpy(idx), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
