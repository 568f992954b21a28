# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""GPT-2 forward, sampling, errors and packaging of the PyTorch port.

The JAX package's `tiny` preset (f32) is initialised from a seed, its flat
parameter dict crosses to the port through numpy (`params_from_numpy`),
and the port's full forward must give the JAX `apply` logits within
1e-4 (the two run the same f32 math in another summation order), the
config knobs too (fp8 weight gather included).  Also pinned: the refused
knobs (an out-of-range dropout, a gather_quant other than "fp8"), the
no-silent-CPU rule of the entry points, the sampling core against JAX's
greedy argmax, and that no file of the port imports jax or the JAX
package.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JAX_PRESETS
from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from tiny_deepspeed_tpu.models.sampling import sample_logits as jax_sample
import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.models import sampling
from tiny_deepspeed_tpu_torch.models.gpt2 import resolved_cache_dtype

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(**overrides):
    """(jax model, jax params, port model) on the tiny preset with the
    same weights."""
    jm = JaxGPT2(dataclasses.replace(JAX_PRESETS["tiny"], **overrides))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"],
                                         **overrides), device="cpu")
    pm.load_state_dict(T.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    return jm, jp, pm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _idx(b=2, t=40, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


class TestForwardParity:
    @pytest.mark.parametrize("position", [None, 17])
    def test_apply_logits_match_jax(self, pair, position):
        jm, jp, pm = pair
        idx = _idx()
        ref = np.asarray(jm.apply(jp, jnp.asarray(idx), position=position))
        got = pm.apply(torch.from_numpy(idx), position=position)
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)

    @pytest.mark.parametrize("overrides", [
        dict(tie_weights=True), dict(bias=False), dict(wte_max_norm=0.5),
        dict(attn_impl="standard_attention"), dict(gather_quant="fp8"),
    ], ids=["tied", "no_bias", "max_norm", "standard_attn", "gather_quant"])
    def test_config_knobs_match_jax(self, overrides):
        jm, jp, pm = _pair(**overrides)
        assert set(pm.param_dict()) == set(jp)
        idx = _idx(t=24, seed=1)
        np.testing.assert_allclose(
            pm.apply(torch.from_numpy(idx)).numpy(),
            np.asarray(jm.apply(jp, jnp.asarray(idx))), **LOGIT_TOL)

    def test_paged_prefill_logits_and_kv(self, pair):
        """The prefill hook: bucket-padded prompt, logits at the true last
        position (== JAX apply there), K/V scattered into the blocks."""
        jm, jp, pm = pair
        prompt = _idx(b=1, t=13, seed=2)
        ref = np.asarray(jm.apply(jp, jnp.asarray(prompt)))[:, 0]
        pool = T.serving.PagedKVPool(n_layer=2, kv_heads=2, head_dim=32,
                                     num_blocks=4, block_tokens=8,
                                     dtype=torch.float32, device="cpu")
        padded = torch.zeros(1, 16, dtype=torch.long)
        padded[0, :13] = torch.from_numpy(prompt[0])
        logits, view = pm.paged_prefill(
            padded, 12, torch.tensor([1, 2]), pool.view, 8)
        np.testing.assert_allclose(logits.numpy(), ref, **LOGIT_TOL)
        assert view.k[1:3].abs().sum() > 0 and view.k[3:].abs().sum() == 0

    def test_params_round_trip(self, pair):
        jm, jp, pm = pair
        back = T.params_to_numpy(pm)
        assert list(back) == list(jp)  # the JAX package's order
        for k, v in jp.items():
            np.testing.assert_array_equal(back[k], np.asarray(v))


class TestInitAndConfig:
    def test_init_is_seeded_and_gpt2_shaped(self):
        cfg = T.GPT2_PRESETS["tiny"]
        a = T.GPT2Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(3))
        b = T.GPT2Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(3))
        for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=n)
        p = a.param_dict()
        assert torch.all(p["h.ln_1.w"] == 1) and torch.all(p["ln_f.b"] == 0)
        assert abs(p["wte"].std().item() - 0.02) < 2e-3
        assert p["h.mlp.proj.w"].std().item() < 0.015  # 1/sqrt(2L) scaled
        assert a.num_params() == sum(x.numel() for x in p.values())

    @pytest.mark.parametrize("knob", [
        dict(dropout=1.0), dict(gather_quant="int8"), dict(attn_impl="ring"),
    ], ids=["dropout", "gather_quant", "attn_impl"])
    def test_refused_knobs_raise(self, knob):
        cfg = dataclasses.replace(T.GPT2_PRESETS["tiny"], **knob)
        with pytest.raises(ValueError):
            T.GPT2Model(cfg, device="cpu")

    def test_cache_dtype_spellings(self):
        cfg = T.GPT2_PRESETS["tiny"]
        assert resolved_cache_dtype(cfg) == torch.float32
        assert resolved_cache_dtype(dataclasses.replace(
            cfg, cache_dtype="bf16")) == torch.bfloat16
        with pytest.raises(ValueError):
            resolved_cache_dtype(dataclasses.replace(cfg, cache_dtype="int3"))

    def test_over_length_sequence_raises(self, pair):
        with pytest.raises(ValueError, match="block_size"):
            pair[2].apply(torch.zeros(1, 257, dtype=torch.long))


class TestNoSilentCpu:
    """Without CUDA and without an explicit device, entry points raise."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_model_raises(self):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.GPT2Model(T.GPT2_PRESETS["tiny"])

    def test_pool_raises(self):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.serving.PagedKVPool(n_layer=1, kv_heads=1, head_dim=8,
                                  num_blocks=2, block_tokens=4,
                                  dtype=torch.float32)

    def test_engine_raises(self, pair):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.ServingEngine(pair[2], T.ServeConfig())


class TestSampling:
    def test_greedy_matches_jax_argmax_incl_ties(self):
        rng = np.random.default_rng(0)
        logit = rng.normal(size=(4, 64)).astype(np.float32)
        logit[1, 5] = logit[1, 40] = logit[1].max() + 1.0  # tie: first wins
        ref = np.asarray(jax_sample(jnp.asarray(logit), None, 0.0, None))
        got = sampling.sample_logits(torch.from_numpy(logit), None, 0.0)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert int(got[1]) == 5

    def test_top_k_restricts_support(self):
        logit = torch.arange(12, dtype=torch.float32)[None]
        for seed in range(8):
            t = int(sampling.sample_logits_at(logit, 0, seed, 0, 1.0, 2)[0])
            assert t in (10, 11)

    def test_stream_depends_only_on_seed_and_position(self):
        logit = torch.zeros(1, 1000)
        a = sampling.sample_logits_at(logit, 7, 3, 11, 1.0)
        b = sampling.sample_logits_at(logit, 7, 3, 11, 1.0)
        c = sampling.sample_logits_per_slot(
            torch.zeros(2, 1000), 7, [5, 3], [0, 11], 1.0)
        assert int(a) == int(b) == int(c[1])
        draws = {int(sampling.sample_logits_at(logit, 7, 3, p, 1.0))
                 for p in range(20)}
        assert len(draws) > 10  # positions decorrelate

    def test_stochastic_needs_generator(self):
        with pytest.raises(ValueError):
            sampling.sample_logits(torch.zeros(1, 4), None, 1.0)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod):
    root = mod.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "tiny_deepspeed_tpu")


class TestPackaging:
    def test_port_never_imports_jax_or_the_jax_package(self):
        files = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                                  "serve_ab.py")]
        pkg = os.path.join(REPO, "tiny_deepspeed_tpu_torch")
        files += [os.path.join(dp, f) for dp, _, fs in os.walk(pkg)
                  for f in fs if f.endswith(".py")]
        bad = {os.path.relpath(p, REPO): m for p in files
               for m in _imports(p) if _forbidden(m)}
        assert not bad, f"port files import the JAX side: {bad}"

    def test_import_pulls_in_no_jax_module(self):
        code = ("import sys, tiny_deepspeed_tpu_torch as T, "
                "tiny_deepspeed_tpu_torch.ops.layernorm, "
                "tiny_deepspeed_tpu_torch.ops.flash_fa2, "
                "tiny_deepspeed_tpu_torch.ops.paged_attn, "
                "tiny_deepspeed_tpu_torch.ops.quant, "
                "tiny_deepspeed_tpu_torch.serving.spec, "
                "tiny_deepspeed_tpu_torch.ops.softmax_xent, "
                "tiny_deepspeed_tpu_torch.train; "
                "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'tiny_deepspeed_tpu', 'triton')))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"

    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
    @pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                      ["serve_ab.py", "."]])
    def test_card_scripts_refuse_without_a_card(self, argv):
        """Without CUDA the on-card scripts exit non-zero, print no
        result, and build nothing."""
        out = subprocess.run([sys.executable] + argv, cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 2, out.stderr
        assert out.stdout == ""
        assert "no CUDA device" in out.stderr

    def test_kernel_sources_ship_with_the_package(self):
        csrc = os.path.join(REPO, "tiny_deepspeed_tpu_torch", "csrc")
        assert {"flash_fwd.cu", "flash_bwd.cu", "paged_attn.cu"} <= set(
            os.listdir(csrc))
        with open(os.path.join(REPO, "pyproject.toml")) as f:
            assert "csrc/*.cu" in f.read()
