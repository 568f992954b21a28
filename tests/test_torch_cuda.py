# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The port's hand-written kernels on the card, against their plain
versions (marker `cuda`; skipped without a CUDA device).

    python -m pytest tests/test_torch_cuda.py -q

Covers what the serving path does not reach at gpt2-124m shapes: a ragged
T, grouped K/V, f32 and f16 operands, block sizes other than 16, and a
tiny-preset engine whose greedy tokens on the card match the CPU port's.
"""

import math

import pytest
import torch

from tiny_deepspeed_tpu_torch.ops import flash_fa2, layernorm, paged_attn
from tiny_deepspeed_tpu_torch.serving import pool as pool_mod

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float16: dict(atol=2e-3, rtol=2e-3)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only there)")


def _g(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,n", [(1, 64), (37, 768), (5, 1000)])
def test_layernorm_kernel(dtype, rows, n):
    g = _g(rows)
    x = (torch.randn(3, rows, n, generator=g, device="cuda") * 2).to(dtype)
    w = torch.randn(n, generator=g, device="cuda").to(dtype)
    b = torch.randn(n, generator=g, device="cuda").to(dtype)
    before = layernorm.layernorm_fwd.launches
    y, mean, rstd = layernorm.layernorm_fwd(x, w, b)
    torch.cuda.synchronize()
    assert layernorm.layernorm_fwd.launches == before + 1
    py, pm, pr = layernorm._ln_fwd_plain(x, w, b)
    torch.testing.assert_close(y.float(), py.float(), **TOL[dtype])
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(rstd, pr, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,kvh,t,d", [
    (1, 12, 12, 1024, 64), (2, 4, 2, 100, 64), (1, 2, 1, 33, 32),
    (3, 2, 2, 1, 64)])
def test_flash_kernel(dtype, b, h, kvh, t, d):
    g = _g(t + h)
    q = torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    before = flash_fa2.fa2_flash_attention_fwd.launches
    o, lse = flash_fa2.fa2_flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash_fa2.fa2_flash_attention_fwd.launches == before + 1
    po, plse = flash_fa2._fa2_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), po.float(), **TOL[dtype])
    torch.testing.assert_close(lse, plse, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("qdt,kdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("hq,kvh,d,bt", [(12, 12, 64, 16), (4, 2, 32, 8),
                                         (2, 1, 128, 32)])
def test_paged_kernel(qdt, kdt, hq, kvh, d, bt):
    s, nl, w = 5, 3, 6
    g = _g(hq * d + bt)
    shape = (s * w + 1, bt, nl, kvh, d)
    view = pool_mod.KVPoolView(
        torch.randn(shape, generator=g, device="cuda").to(kdt),
        torch.randn(shape, generator=g, device="cuda").to(kdt))
    tables = (torch.randperm(s * w, generator=g, device="cuda") + 1
              ).reshape(s, w).to(torch.int32)
    pos = torch.tensor([0, bt - 1, bt, 3 * bt + 2, w * bt - 1],
                       dtype=torch.int32, device="cuda")
    page = pool_mod.page_ref(tables, pos, bt)
    q = torch.randn(s, hq, 1, d, generator=g, device="cuda").to(qdt)
    for layer in range(nl):
        o = paged_attn.paged_attention(q, view, page, layer)
        torch.cuda.synchronize()
        po = paged_attn._paged_attention_plain(q, view, page, layer)
        assert o.dtype == qdt
        torch.testing.assert_close(o.float(), po.float(),
                                   **TOL[kdt if kdt != torch.float32
                                         else qdt])


def test_tiny_engine_tokens_match_cpu():
    """f32 tiny preset: the card (all three kernels) and the CPU port
    (plain versions) produce the same greedy tokens."""
    import tiny_deepspeed_tpu_torch as T
    cfg = T.GPT2_PRESETS["tiny"]
    cpu = T.GPT2Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gpu = T.GPT2Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        eng = T.ServingEngine(model, T.ServeConfig(
            max_active=3, num_blocks=7, block_tokens=8, max_seq_tokens=64),
            device=dev)
        hs = [eng.submit(list(range(3 + i, 30 + 2 * i)), 12)
              for i in range(4)]
        eng.drain(max_ticks=500)
        outs.append([h.tokens for h in hs])
    assert outs[0] == outs[1]
    assert math.isfinite(float(gpu.apply(
        torch.zeros(1, 8, dtype=torch.long, device="cuda")).sum()))
