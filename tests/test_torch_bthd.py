# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's heads-last FA2 entry (`fa2_flash_attention_bthd`, TPU
kernels #7 and #8) against the JAX package's, on the CPU.

The same seeded numpy q/k/v (B, T, H, Dh) f32 go through JAX's
`fa2_flash_attention_bthd` — its `_ah` Pallas kernels in interpret mode,
as tests/test_flash_fa2.py runs them — and through the port's entry,
whose CPU tensors take the plain versions (transpose, the standard FA2
plain versions, transpose back): o and the gradients of sum(o^2) with
respect to q, k and v within 1e-5.  Also past JAX's `_AH_MAX_T_HD` panel
bound, where the JAX entry transposes over to its standard kernels (the
constant is patched inside the test) and the port, which has one path
for every size, must still agree.  KVH != H raises (the JAX kernels index
k/v with q's head), the plain versions equal the (B, H, T, Dh) ones on
transposed copies, and the A/B module imports and runs on the CPU.  On
the card the kernels' parity and bit-identity with #4-#6 are
tests/test_torch_cuda.py's.
"""

import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu_torch import fa2_bthd_ab
from tiny_deepspeed_tpu_torch.ops import flash_fa2 as fa

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b=2, t=256, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax_bthd(q, k, v, monkeypatch, past_bound=False):
    import jax
    import jax.numpy as jnp
    from tiny_deepspeed_tpu.ops import flash_fa2 as jfa
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    if past_bound:
        monkeypatch.setattr(jfa, "_AH_MAX_T_HD", 1)

    def loss(*a):
        return jnp.sum(jfa.fa2_flash_attention_bthd(*a, 128, 128) ** 2)

    args = [jnp.asarray(x) for x in (q, k, v)]
    o = jfa.fa2_flash_attention_bthd(*args, 128, 128)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(x) for x in (o, *grads)]


def _port_bthd(q, k, v):
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fa.fa2_flash_attention_bthd(*args, 128, 128)
    grads = torch.autograd.grad(o.square().sum(), args)
    return [x.detach().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("past_bound", [False, True],
                         ids=["all_heads_path", "past_ah_max_t_hd"])
def test_bthd_matches_jax(monkeypatch, past_bound):
    q, k, v = _qkv()
    want = _jax_bthd(q, k, v, monkeypatch, past_bound)
    got = _port_bthd(q, k, v)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_bthd_plain_equals_bhtd_plain_on_transposes():
    """The plain versions are the (B, H, T, Dh) ones on transposed
    copies, forward and both backward passes, bit for bit."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(b=1, t=96, h=3, d=32))
    do = torch.from_numpy(_qkv(b=1, t=96, h=3, d=32, seed=1)[0])
    o, lse = fa.fa2_flash_attention_bthd_fwd(q, k, v)
    di = (do * o).sum(-1).transpose(1, 2)
    tr = [x.transpose(1, 2) for x in (q, k, v, do)]
    ro, rlse = fa.fa2_flash_attention_fwd(*tr[:3])
    assert torch.equal(o, ro.transpose(1, 2)) and torch.equal(lse, rlse)
    assert torch.equal(fa.fa2_flash_attention_bthd_dq(q, k, v, do, lse, di),
                       fa.fa2_flash_attention_dq(*tr, lse, di)
                       .transpose(1, 2))
    for a, b in zip(fa.fa2_flash_attention_bthd_dkv(q, k, v, do, lse, di),
                    fa.fa2_flash_attention_dkv(*tr, lse, di)):
        assert torch.equal(a, b.transpose(1, 2))


def test_bthd_refuses_grouped_kv():
    q = torch.zeros(1, 16, 4, 32)
    kv = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="MHA"):
        fa.fa2_flash_attention_bthd(q, kv, kv)
    with pytest.raises(ValueError, match="MHA"):
        fa.fa2_flash_attention_bthd_dkv(q, kv, kv, q, torch.zeros(1, 4, 16),
                                        torch.zeros(1, 4, 16))


def test_ab_module_runs_on_the_cpu(capsys):
    """The A/B imports without a card and times both arms on the CPU
    (its plain path); both arms compute the same gradients."""
    rows = fa2_bthd_ab.run("cpu", iters=1, batch=1, heads=2, seq=64,
                           head_dim=32)
    assert [r["arm"] for r in rows] == ["transpose+fa2", "bthd_fa2"]
    assert all(r["fb_ms"] > 0 for r in rows)
    assert len(capsys.readouterr().out.splitlines()) == 2
    q, k, v = fa2_bthd_ab.inputs("cpu", 1, 2, 64, 32)
    a = fa2_bthd_ab.fwd_bwd(fa2_bthd_ab.arm_transpose, q, k, v)
    b = fa2_bthd_ab.fwd_bwd(fa2_bthd_ab.arm_bthd, q, k, v)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
