# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The residual add fused into LayerNorm (`ops/layernorm.add_layernorm`)
on the CPU: its plain version, its autograd Function, and the tiny
model that calls it, against the composition and the JAX package.

JAX fuses nothing here: it adds, then norms (`ops/layernorm_pallas.py`
`ln_fwd_pallas`, interpret mode, or the XLA path).  So the port's
`add_layernorm_fwd` must be `x + r` (rounded to the compute dtype)
followed by the forward, bit for bit, and within 1e-5 of the JAX
forward on x + r.  `AddLayerNormFn`'s gradients must equal autograd's
through `x + r` and `LayerNormFn` bit for bit, also under
`torch.utils.checkpoint` with the model's selective policy, and be
within 1e-5 of `jax.grad`.  The tiny model's paged decode, verify span
and training step, which now route every residual add but the first
ln_1's and the last MLP's through it, still match JAX at the model
tests' tolerances (logits 1e-4, gradients rtol 1e-4).  The card holds
the Triton kernel to this plain version (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as ckpt

import tiny_deepspeed_tpu.ops.layernorm_pallas as JLN
import tiny_deepspeed_tpu.ops.paged_attn_pallas as JPA
from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from tiny_deepspeed_tpu.ops.layernorm import layernorm as jax_layernorm
from tiny_deepspeed_tpu.serving import pool as jpool
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import gpt2 as tgpt2
from tiny_deepspeed_tpu_torch.ops import layernorm
from tiny_deepspeed_tpu_torch.serving import pool as tpool

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JLN, "INTERPRET", True)
    monkeypatch.setattr(JPA, "INTERPRET", True)


def _operands(rows, n, dtype, seed):
    """x, r, w, b, g_s, g_y from numpy, x and r in `dtype`."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * 2 + 0.3).astype(np.float32)
    r, gs, gy = (rng.standard_normal((rows, n)).astype(np.float32)
                 for _ in range(3))
    w, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    t = [torch.from_numpy(a) for a in (x, r, w, b, gs, gy)]
    return [a.to(dtype) for a in t[:2]] + t[2:]


# -- the op ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", [(8, 768), (40, 768), (3, 5, 64)],
                         ids=["decode", "verify", "batched"])
def test_plain_is_add_then_norm(shape, dt):
    """(s, y, mean, rstd) bit for bit `x + r` then `_ln_fwd_plain`."""
    dtype = DTYPES[dt][0]
    rows, n = int(np.prod(shape[:-1])), shape[-1]
    x, r, w, b, *_ = _operands(rows, n, dtype, seed=rows)
    x, r = x.reshape(shape), r.reshape(shape)
    got = layernorm.add_layernorm_fwd(x, r, w.to(dtype), b.to(dtype))
    s = x + r
    want = (s, *layernorm._ln_fwd_plain(s, w.to(dtype), b.to(dtype)))
    for a, c in zip(got, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, c)
    assert layernorm.add_layernorm_fwd.launches == 0  # CPU: plain version


@pytest.mark.parametrize("dt", list(DTYPES))
def test_forward_matches_jax(dt):
    """s equals JAX's `x + r` bit for bit; y, mean and rstd are within
    1e-5 of the Pallas forward (interpret mode) on that sum."""
    dtype, jdt = DTYPES[dt]
    x, r, w, b, *_ = _operands(24, 96, dtype, seed=5)
    s, y, mean, rstd = layernorm.add_layernorm_fwd(x, r, w.to(dtype),
                                                   b.to(dtype))
    js = (jnp.asarray(x.float().numpy()).astype(jdt)
          + jnp.asarray(r.float().numpy()).astype(jdt))
    jy, jmean, jrstd = JLN.ln_fwd_pallas(js, jnp.asarray(w.numpy()).astype(
        jdt), jnp.asarray(b.numpy()).astype(jdt))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), **TOL)


def _fused(x, r, w, b):
    return layernorm.add_layernorm(x, r, w, b)


def _composed(x, r, w, b):
    s = x + r
    return s, layernorm.layernorm(s, w, b)


def _block_like(fn, x, r, w, b, proj):
    """What the model does around the norm: the sum feeds the residual,
    the normed rows a matmul (an aten.mm the selective policy keeps)."""
    s, y = fn(x, r, w, b)
    return s + torch.tanh(y @ proj)


@pytest.mark.parametrize("remat", [None, "nothing", "dots_no_batch"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_function_grads_equal_composition(dt, remat):
    """Gradients of x, r, w (f32 master) and b through `AddLayerNormFn`
    equal autograd's through `x + r` and `LayerNormFn` bit for bit —
    called directly with given (g_s, g_y), and inside a checkpointed
    block under the model's remat policies."""
    dtype = DTYPES[dt][0]
    x, r, w, b, gs, gy = _operands(16, 64, dtype, seed=7)
    proj = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (64, 64)).astype(np.float32)).to(dtype) * 0.1
    out = []
    for fn in (_fused, _composed):
        leaves = [t.clone().requires_grad_() for t in (x, r, w, b)]
        args = (leaves[0], leaves[1], leaves[2].to(dtype),
                leaves[3].to(dtype))
        if remat is None:
            s, y = fn(*args)
            grads = torch.autograd.grad((s, y), leaves,
                                        (gs.to(dtype), gy.to(dtype)))
            vals = (s, y)
        else:
            kw = {}
            save = tgpt2._REMAT_SAVE[remat]
            if save:
                kw["context_fn"] = functools.partial(
                    ckpt.create_selective_checkpoint_contexts,
                    tgpt2._save_policy(save))
            o = ckpt.checkpoint(_block_like, fn, *args, proj,
                                use_reentrant=False, **kw)
            grads = torch.autograd.grad(o, leaves, gs.to(dtype))
            vals = (o,)
        out.append((vals, grads))
    (fv, fg), (cv, cg) = out
    for a, c in zip(fv + fg, cv + cg):
        assert a.dtype == c.dtype and torch.equal(a, c)


def test_function_grads_match_jax():
    """f32: x, r, w, b gradients of sum(y * g_y + s * g_s) within 1e-5 of
    jax.grad through JAX's add and custom-vjp layernorm."""
    x, r, w, b, gs, gy = _operands(12, 64, torch.float32, seed=9)

    def jloss(x_, r_, w_, b_):
        s = x_ + r_
        y = jax_layernorm(s, w_, b_)
        return jnp.sum(y * jnp.asarray(gy.numpy())) + jnp.sum(
            s * jnp.asarray(gs.numpy()))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.numpy()) for t in (x, r, w, b)))
    leaves = [t.clone().requires_grad_() for t in (x, r, w, b)]
    s, y = layernorm.add_layernorm(*leaves)
    ((y * gy).sum() + (s * gs).sum()).backward()
    for t, ref in zip(leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL)


# -- the tiny model --------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT2(JAX_PRESETS["tiny"])
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    pm.load_state_dict(T.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    return jm, jp, pm


BT, NB = 8, 12
TABLES = np.asarray([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32)


def _same_pools(seed):
    """The tiny preset's f32 pool, the same random contents on both sides
    (positions < pos hold a committed prefix)."""
    shape = (NB + 1, BT, 2, 2, 32)
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return (jpool.KVPoolView(jnp.asarray(k), jnp.asarray(v), None, None),
            tpool.KVPoolView(torch.from_numpy(k.copy()),
                             torch.from_numpy(v.copy())))


def test_tiny_paged_decode_matches_jax(pair):
    """Two decode steps of three slots at mixed positions: logits within
    1e-4 of JAX's, and the pools they wrote equal within 1e-4."""
    jm, jp, pm = pair
    jview, tview = _same_pools(1)
    jst, tst = jm.stacked_compute_params(jp), pm.stacked_compute_params()
    pos = np.asarray([17, 9, 3], np.int32)
    toks = np.asarray([5, 300, 77], np.int32)
    for _ in range(2):
        jpage = jpool.page_ref(jnp.asarray(TABLES), jnp.asarray(pos), BT)
        tpage = tpool.page_ref(torch.from_numpy(TABLES),
                               torch.from_numpy(pos), BT)
        jx = jm._embed_decode(jp, jnp.asarray(toks), jnp.asarray(pos))
        jx, jview = jm.paged_decode(jst, jx, jview, jpage)
        jl = np.asarray(jm.head(jp, jx))[:, 0]
        tx = pm._embed_decode(torch.from_numpy(toks).long(),
                              torch.from_numpy(pos))
        tx, tview = pm.paged_decode(tst, tx, tview, tpage)
        with torch.no_grad():
            tl = pm.head(tx)[:, 0]
        np.testing.assert_allclose(tl.numpy(), jl, **LOGIT_TOL)
        toks = jl.argmax(-1).astype(np.int32)
        pos = pos + 1
    for a, c in zip(tview[:2], jview[:2]):
        np.testing.assert_allclose(a.numpy()[1:], np.asarray(c)[1:],
                                   **LOGIT_TOL)


def test_tiny_paged_verify_matches_jax(pair):
    """A verify span of K1 = 4 per slot: the (S, K1, V) logits and the
    span K/V stacks within 1e-4 of JAX's."""
    jm, jp, pm = pair
    jview, tview = _same_pools(2)
    pos0 = np.asarray([12, 5, 0], np.int32)
    toks = np.random.default_rng(3).integers(0, 512, (3, 4)).astype(np.int32)
    positions = pos0[:, None] + np.arange(4)[None, :]
    jpage = jpool.page_ref(jnp.asarray(TABLES), jnp.asarray(pos0), BT)
    tpage = tpool.page_ref(torch.from_numpy(TABLES),
                           torch.from_numpy(pos0), BT)
    jx = jm._embed_decode_span(jp, jnp.asarray(toks), jnp.asarray(positions))
    jx, jks, jvs = jm.paged_verify(jm.stacked_compute_params(jp), jx, jview,
                                   jpage)
    jl = jm.head_span(jp, jx)
    tx = pm._embed_decode_span(torch.from_numpy(toks).long(),
                               torch.from_numpy(positions))
    tx, tks, tvs = pm.paged_verify(pm.stacked_compute_params(), tx, tview,
                                   tpage)
    with torch.no_grad():
        tl = pm.head_span(tx)
    for got, ref in ((tl, jl), (tks, jks), (tvs, jvs)):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_tiny_training_step_matches_jax(pair, remat):
    """One training forward and backward: the loss within 1e-5 and every
    gradient within rtol 1e-4 of jax.value_and_grad (each block's
    attention residual and ln_2 now one `add_layernorm`)."""
    jm, jp, pm = pair
    rng = np.random.default_rng(4)
    idx, tgt = (rng.integers(0, 512, (2, 32)) for _ in range(2))
    jl, jg = jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(idx), jnp.asarray(tgt)))(jp)
    saved = pm.config
    pm.config = dataclasses.replace(saved, remat=remat)
    try:
        loss = pm.apply(torch.from_numpy(idx), torch.from_numpy(tgt))
        names = [n for n, _ in pm.named_parameters()]
        grads = torch.autograd.grad(loss, list(pm.parameters()))
    finally:
        pm.config = saved
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]),
                                   err_msg=n, **GRAD_TOL)
