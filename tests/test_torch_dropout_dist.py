# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Dropout on more than one rank: counter-based, rank-invariant masks,
on the CPU, in f32 (gpt2-tiny with dropout 0.1).

Pinned here:

- `ops.dropout`: a block of a mask drawn at its offsets is bit for bit
  that block of the whole mask, for the data, seq and data x seq
  layouts `models.gpt2._dropout_frame` gives; the wrapper and its
  autograd Function launch the kernel once forward and once backward
  when the tensor is on the card (`on_cuda` patched), never the plain
  version; the schedule's explicit grad lowerings build with dropout on
  more than one rank;
- DDP, Zero1, Zero2 and Zero3 at data 2 (one 2-rank gloo spawn) and
  Zero2 at data 2 x seq 2 under the ring and under Ulysses (one 4-rank
  spawn, run by tests/test_torch_dropout_seq.py), 10 steps, each run twice in its spawn (Zero3 with the
  prefetch executor, `gather_prefetch=2`, once, with the port's masks):
  - with the port's masks: every mask a rank draws in the first step is
    bit for bit its block of the one-rank mask, and the losses equal
    the port's SingleDevice on the same global batches within 1e-5;
  - with JAX's masks (each drawn over the global (B, T, C) shape by
    `jax.random.bernoulli`, as JAX's engines draw them under GSPMD)
    patched in at `_dropout_keep` as each rank's block: against the JAX
    engine of the layout, losses 1e-4, params and optimizer state 1e-5
    (tests/test_torch_dist.py's rule).
- in the same 2-rank spawn, the explicit grad lowerings, which run each
  rank's own batch as on one device and draw rank-local masks as JAX's
  do (the step's key folded with the data rank, then with the
  microbatch): DDP int8 ("quant_mono"), Zero2 `grad_buckets=2`
  ("bucket"), each also at `accum_steps=2`, and Zero3
  `gather_prefetch=2, grad_buckets=2` ("composed"):
  - with the port's masks (one step): every mask a rank draws is the
    one-device draw (no frame) under a key of the rank's key tree,
    `fold_in(fold_in(fold_in(base, step), rank)[, microbatch])` split
    into the embedding's and the layers' keys;
  - with JAX's masks (each rank's `jax.random.bernoulli` over its own
    (B/2, T, C) block from JAX's key tree) patched in: the bucket and
    composed cases against the JAX engine with the same knobs at the
    distributed rule (losses 1e-4, params and optimizer state 1e-5).
    The int8 codec's free-running state drifts from JAX's (a code
    flipped by roundoff; tests/test_torch_grad_comm_engines.py), so the
    "quant_mono" cases are held there, in its spawn, by its rule (JAX's
    dither and these masks patched in, each step teacher-forced).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch import rng as prng
from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
from tiny_deepspeed_tpu_torch.ops import dropout as D
from tiny_deepspeed_tpu_torch.parallel.mesh import ParallelContext
from test_torch_dist import (B, SEQ, STEPS, _batches, _jax_run,
                             _optimizer, compare_with_jax,
                             multi_engine_worker)
from test_torch_ring import spawn

RATE = 0.1
DROP = dict(dropout=RATE)
PBASE = prng.fold_in(0, 0xD0)  # the port's dropout base at init(0)


def _frame_block(mask, shape, frame):
    """The block of a whole mask that a `shape` block at `frame` holds."""
    if frame is None:
        return mask
    return mask[tuple(slice(o, o + n) for o, n in zip(frame[1], shape))]


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 4), (2, 2), (4, 2)])
def test_rank_blocks_are_blocks_of_the_one_rank_mask(dp, sp):
    key = prng.fold_in(PBASE, 5)
    b, t, c = 8, 16, 24
    whole = D.dropout_keep(key, (b, t, c), 1 - RATE, "cpu")
    x = torch.randn(b, t, c)
    y = gpt2_mod._dropout(x, key, RATE)
    for r in range(dp * sp):
        d, s = divmod(r, sp)
        pctx = ParallelContext(world=dp * sp, rank=r, data_size=dp,
                               seq_size=sp, data_rank=d, seq_rank=s)
        shape = (b // dp, t // sp, c)
        frame = gpt2_mod._dropout_frame(shape, pctx)
        assert frame == ((b, t, c), (d * shape[0], s * shape[1], 0))
        got = gpt2_mod._dropout_keep(key, shape, 1 - RATE, "cpu", frame)
        assert torch.equal(got, _frame_block(whole, shape, frame))
        xs = _frame_block(x, shape, frame)
        assert torch.equal(gpt2_mod._dropout(xs, key, RATE, pctx),
                           _frame_block(y, shape, frame))
    assert gpt2_mod._dropout_frame((2, 3, 4), None) is None
    # the share kept and a frame that leaves its tensor
    assert abs(float(whole.float().mean()) - (1 - RATE)) < 0.02
    with pytest.raises(ValueError, match="leaves"):
        D.dropout_keep(key, (4, 4), 0.9, "cpu", ((4, 4), (1, 0)))


def test_cuda_tensors_route_to_the_kernel(monkeypatch):
    """With `on_cuda` true, `DropoutFn` calls the kernel's wrapper once
    forward and once backward (the same key, keep and frame) and never
    the plain version."""
    calls = []
    plain = D._dropout_plain

    def kernel(x, key, keep, frame):
        calls.append((key, keep, frame))
        return plain(x, key, keep, frame)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(D, "on_cuda", lambda *t: True)
    monkeypatch.setattr(D, "_dropout_triton", kernel)
    monkeypatch.setattr(D, "_dropout_plain", refuse)
    frame = ((4, 6, 8), (2, 0, 0))
    x = torch.randn(2, 6, 8, requires_grad=True)
    y = D.dropout(x, 77, RATE, frame)
    (y * y).sum().backward()
    assert calls == [(77, 1 - RATE, frame)] * 2
    mask = D.dropout_keep(77, (2, 6, 8), 1 - RATE, "cpu", frame)
    assert torch.equal(x.grad == 0, ~mask)


@pytest.mark.parametrize("knob,lowering", [
    (dict(grad_buckets=2), "bucket"), (dict(grad_comm="int8"), "quant_mono")])
def test_explicit_lowerings_refuse_dropout_on_two_ranks(knob, lowering):
    """The schedule's explicit grad lowerings no longer refuse dropout on
    more than one rank: with and without it they build the same
    lowering (their masks are held in `check_spawn`)."""
    pctx = ParallelContext(world=2, rank=0, data_size=2, seq_size=1,
                           data_rank=0, seq_rank=0)
    for cfg in (dataclasses.replace(T.GPT2_PRESETS["tiny"], **DROP),
                T.GPT2_PRESETS["tiny"]):
        eng = T.DDP(T.GPT2Model(cfg, device="cpu"), T.AdamW(),
                    device="cpu", pctx=pctx, **knob)
        assert eng._schedule.lowering == lowering


def _record_hook(rank, out_dir, tag):
    """The port's masks, recorded: (key, shape, frame, mask) of every
    draw in the first step."""
    orig = gpt2_mod._dropout_keep
    seen = []

    def record(key, shape, keep, device, frame=None):
        m = orig(key, shape, keep, device, frame)
        if len(seen) < 64:
            seen.append((key, tuple(shape), frame, m.clone()))
        return m

    gpt2_mod._dropout_keep = record

    def done():
        gpt2_mod._dropout_keep = orig
        torch.save(seen, os.path.join(out_dir, f"masks{tag}_{rank}.pt"))
    return done


def _jax_mask_hook(rank, out_dir, tag, ref):
    """JAX's global masks of the JAX run `ref`, keyed by the port's key
    for the same place, patched in as each rank's block."""
    orig = gpt2_mod._dropout_keep
    table = dict(np.load(os.path.join(out_dir, f"jmasks{ref}.npz")))

    def keep_mask(key, shape, keep, device, frame=None):
        assert abs(keep - (1 - RATE)) < 1e-12
        return torch.from_numpy(_frame_block(table[str(key)], shape, frame))

    gpt2_mod._dropout_keep = keep_mask

    def done():
        gpt2_mod._dropout_keep = orig
    return done


def _jax_masks(jbase, n_layer, c):
    """{str(port key): JAX's global (B, T, C) mask} for every place of
    the STEPS steps: the embedding's from keys[0], layer l site s from
    fold_in(keys[l + 1], s), as JAX's `_dropout_setup` and `_block`."""
    import jax
    table = {}
    for n in range(STEPS):
        pk = prng.split(prng.fold_in(PBASE, n), n_layer + 1)
        jk = jax.random.split(jax.random.fold_in(jbase, n), n_layer + 1)
        places = [(pk[0], jk[0])] + [
            (prng.fold_in(pk[l + 1], s), jax.random.fold_in(jk[l + 1], s))
            for l in range(n_layer) for s in (0, 1)]
        for p, j in places:
            table[str(p)] = np.asarray(
                jax.random.bernoulli(j, 1 - RATE, (B, SEQ, c)))
    return table


def _single_device_losses(init):
    """The port's SingleDevice with dropout from JAX's initial params."""
    model = T.GPT2Model(dataclasses.replace(T.GPT2_PRESETS["tiny"], **DROP),
                        device="cpu")
    eng = T.SingleDevice(model, _optimizer("adamw"), device="cpu")
    state = eng.init(0)
    assert state.dropout_base == PBASE
    eng.load_params(state, T.params_from_numpy(dict(init), "cpu"))
    return [float(eng.step(state, b)[1]) for b in _batches(STEPS)], model


# spawn -> (world, its JAX reference runs (engine, dp, sp, seq_impl), and
# [(engine, dp, sp, seq_impl, engine knobs, the JAX run it is held to)]).
# JAX's stages compute the same numbers, so one JAX run serves each
# layout's engines; JAX's masks do not depend on the layout either.
# Zero3's prefetch executor runs the layers itself (the blocks get the
# rank's layout from it): held to SingleDevice only, as JAX's scheduled
# scan draws its masks inside a shard_map
_SPAWNS = {
    "data2": (2, {"ddp": ("DDP", 2, 1, "ring")}, [
        ("DDP", 2, 1, "ring", {}, "ddp"), ("Zero1", 2, 1, "ring", {}, "ddp"),
        ("Zero2", 2, 1, "ring", {}, "ddp"), ("Zero3", 2, 1, "ring", {}, "ddp"),
        ("Zero3", 2, 1, "ring", dict(gather_prefetch=2), None)]),
    # JAX's Zero2 under the ring serves Ulysses too: the masks are JAX's
    # global draws either way, and the attention is exact under both
    # (tests/test_torch_ulysses_dist.py holds Ulysses to JAX's Ulysses)
    "data2_seq2": (4, {"ring": ("Zero2", 2, 2, "ring")}, [
        ("Zero2", 2, 2, "ring", {}, "ring"),
        ("Zero2", 2, 2, "ulysses", {}, "ring")]),
}


# the explicit grad lowerings at data 2: (engine, knobs, accum, lowering,
# held to JAX's engine here)
_EXPLICIT = {
    "quant_mono": ("DDP", dict(grad_comm="int8"), 1, "quant_mono", False),
    "quant_mono-accum2": ("DDP", dict(grad_comm="int8"), 2, "quant_mono",
                          False),
    "bucket": ("Zero2", dict(grad_buckets=2), 1, "bucket", True),
    "bucket-accum2": ("Zero2", dict(grad_buckets=2), 2, "bucket", True),
    "composed": ("Zero3", dict(gather_prefetch=2, grad_buckets=2), 1,
                 "composed", True),
}


def _rank_keys(n, rank, mb, accum, n_layer, jbase=None):
    """The places of rank `rank`'s microbatch `mb` at step n under an
    explicit lowering: [(port key, JAX key or None)] — the embedding's,
    then each layer's two sites (JAX schedule.py:1337-1356)."""
    pk = prng.fold_in(prng.fold_in(PBASE, n), rank)
    jk = None
    if jbase is not None:
        import jax
        jk = jax.random.fold_in(jax.random.fold_in(jbase, n), rank)
    if accum > 1:
        pk = prng.fold_in(pk, mb)
        if jk is not None:
            jk = jax.random.fold_in(jk, mb)
    pks = prng.split(pk, n_layer + 1)
    jks = None if jk is None else jax.random.split(jk, n_layer + 1)
    out = [(pks[0], None if jks is None else jks[0])]
    for l in range(n_layer):
        for site in (0, 1):
            out.append((prng.fold_in(pks[l + 1], site),
                        None if jks is None
                        else jax.random.fold_in(jks[l + 1], site)))
    return out


def _jax_local_masks(jbase, n_layer, c, accum, dp=2):
    """{str(port key): JAX's mask of that place over the rank's own
    (B/dp, T, C) block}, every rank, microbatch and step."""
    import jax
    table = {}
    for n in range(STEPS):
        for r in range(dp):
            for mb in range(accum):
                for p, j in _rank_keys(n, r, mb, accum, n_layer, jbase):
                    table[str(p)] = np.asarray(jax.random.bernoulli(
                        j, 1 - RATE, (B // dp, SEQ, c)))
    return table


@pytest.mark.parametrize("spawn_id", ["data2"])
def test_engines_drop_rank_invariant_masks(tmp_path, spawn_id):
    """(data2_seq2: tests/test_torch_dropout_seq.py)"""
    check_spawn(tmp_path, spawn_id)


def _explicit_runs(tmp_path, c):
    """JAX's engines of `_EXPLICIT` held here (their masks written) and
    the port's configurations for the data-2 spawn: every case once with
    the port's masks (one step, recorded), the held ones with JAX's:
    (JAX runs, spawn configurations)."""
    outs, runs = {}, []
    for cid, (name, kw, accum, _, held) in _EXPLICIT.items():
        base = dict(name=name, sp=1, kw=kw, opt="adamw", accum=accum,
                    overflow=False, model_kw=DROP, params="")
        runs.append(dict(base, tag=f"xp{cid}", hook=(_record_hook, ()),
                         steps=1))
        if not held:
            continue
        outs[cid] = _jax_run(name, 2, 1, kw, "adamw", accum, False, DROP)
        np.savez(tmp_path / f"jmasks{cid}.npz", **_jax_local_masks(
            outs[cid][2].dropout_base, c.n_layer, c.n_embd, accum))
        runs.append(dict(base, tag=f"xj{cid}",
                         hook=(_jax_mask_hook, (cid,))))
    return outs, runs


def _check_explicit(tmp_path, outs, c):
    for cid, (name, kw, accum, lowering, held) in _EXPLICIT.items():
        res = torch.load(tmp_path / f"resultxp{cid}.pt")
        assert res["lowering"] == lowering
        for r in range(2):
            seen = torch.load(tmp_path / f"masksxp{cid}_{r}.pt")
            keys = {p for mb in range(accum)
                    for p, _ in _rank_keys(0, r, mb, accum, c.n_layer)}
            assert {key for key, *_ in seen} == keys, (cid, r)
            for key, shape, frame, m in seen:
                assert frame is None and shape == (B // 2, SEQ, c.n_embd)
                assert torch.equal(m, D.dropout_keep(key, shape, 1 - RATE,
                                                     "cpu"))
        if held:
            assert outs[cid][3]._schedule.lowering == lowering
            compare_with_jax(torch.load(tmp_path / f"resultxj{cid}.pt"),
                             outs[cid], 2)


def check_spawn(tmp_path, spawn_id):
    """Every configuration of one gloo spawn, with the port's masks and
    with JAX's, as the module docstring says."""
    world, jax_runs, configs = _SPAWNS[spawn_id]
    outs = {k: _jax_run(name, dp, sp, dict(seq_impl=impl), "adamw", 1,
                        False, DROP)
            for k, (name, dp, sp, impl) in jax_runs.items()}
    init = next(iter(outs.values()))[0]
    want, model = _single_device_losses(init)
    c = model.config
    np.savez(tmp_path / "params.npz", **init)
    for k, out in outs.items():
        np.savez(tmp_path / f"jmasks{k}.npz",
                 **_jax_masks(out[2].dropout_base, c.n_layer, c.n_embd))
    explicit = world == 2
    xouts, runs = _explicit_runs(tmp_path, c) if explicit else ({}, [])
    for i, (name, dp, sp, impl, knobs, ref) in enumerate(configs):
        modes = [(f"p{i}", (_record_hook, ()))]
        if ref is not None:
            modes.append((f"j{i}", (_jax_mask_hook, (ref,))))
        for tag, hook in modes:
            runs.append(dict(name=name, sp=sp,
                             kw=dict(knobs, seq_impl=impl), opt="adamw",
                             accum=1, overflow=False, model_kw=DROP,
                             tag=tag, hook=hook, params=""))
    spawn(multi_engine_worker, world, tmp_path, runs,
          timeout=240 + 60 * len(xouts))
    for i, (name, dp, sp, impl, knobs, ref) in enumerate(configs):
        # the port's masks: the one-rank masks' blocks, SingleDevice's run
        res = torch.load(tmp_path / f"resultp{i}.pt")
        np.testing.assert_allclose(res["losses"], want, rtol=1e-5,
                                   err_msg=f"{name} {impl} {knobs}")
        for r in range(world):
            seen = torch.load(tmp_path / f"masksp{i}_{r}.pt")
            assert len(seen) == 64  # the first 64 draws
            d, s = divmod(r, sp)
            for key, shape, frame, m in seen:
                assert frame == ((B, SEQ, c.n_embd),
                                 (d * B // dp, s * SEQ // sp, 0))
                whole = D.dropout_keep(key, frame[0], 1 - RATE, "cpu")
                assert torch.equal(m, _frame_block(whole, shape, frame))
        if ref is not None:  # JAX's masks: JAX's engine
            compare_with_jax(torch.load(tmp_path / f"resultj{i}.pt"),
                             outs[ref], dp)
    if explicit:
        _check_explicit(tmp_path, xouts, c)
