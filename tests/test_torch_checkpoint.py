# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Checkpoint and resume of the PyTorch port (`utils/checkpoint.py`), on
the CPU.

Pinned here:

- the commit protocol: a tmp dir is never listed, an uncommitted
  `step_*` dir is skipped and named in the errors, a committed step is
  never re-saved, a `write` failure from the io hook is retried (and
  fails after the bound), `CheckpointKilled` leaves the partial dir;
  `latest_step` and `read_meta`;
- SingleDevice on the `tiny` preset with dropout 0.1, a dynamic loss
  scale and a warmup schedule: 3 steps, save, a fresh model and engine
  loaded, 3 more, bit for bit the uninterrupted 6 (losses, params, the
  optimizer's moments and step, the scaler); the losses within 1e-4 of
  the JAX `SingleDevice`'s uninterrupted 6 (JAX's dropout masks patched
  into the port's draws, as tests/test_torch_knobs.py does);
- Zero1 and Zero3 at data 2 over gloo (one spawn of 2 ranks) resumed bit
  for bit; the data-2 checkpoint refused at world 1 (elastic resume is
  not ported); `load_params` joins ZeRO-3's shards into the gathered
  params;
- `train.main(... --checkpoint-every 3)` then `--resume` prints the
  uninterrupted run's losses, and `generate.main(["--ckpt", ...])` gives
  `model.generate`'s tokens on the trained params.

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch import generate as gen_mod
from tiny_deepspeed_tpu_torch import rng as prng
from tiny_deepspeed_tpu_torch import train as train_mod
from tiny_deepspeed_tpu_torch.models import gpt2 as gpt2_mod
from tiny_deepspeed_tpu_torch.optim import schedule as tsched
from tiny_deepspeed_tpu_torch.utils import checkpoint as ck
from test_torch_dist import world1  # noqa: F401
from test_torch_ring import spawn

LR, STEPS, SPLIT = 1e-3, 6, 3


def _batches(n, b=2, t=32):
    loader = T.TokenLoader(None, b, t, vocab_size=512, seed=3)
    return [loader.next() for _ in range(n)]


def _single(dropout=0.1):
    """SingleDevice on `tiny` with dropout, a dynamic loss scale growing
    every 2 clean steps and a warmup-linear schedule."""
    cfg = dataclasses.replace(T.GPT2_PRESETS["tiny"], dropout=dropout)
    model = T.GPT2Model(cfg, device="cpu")
    return T.SingleDevice(
        model, T.AdamW(lr=tsched.warmup_linear(LR, STEPS, warmup_steps=2),
                       weight_decay=0.1),
        device="cpu", loss_scale="dynamic", loss_scale_growth_interval=2)


def _snapshot(engine, state):
    opt = engine.gather_opt_state(state)
    return {"params": engine.gather_params(state), "step": opt["step"],
            "slots": opt["state"], "scaler": state.scaler,
            "dropout_base": state.dropout_base}


def _assert_same(a, b):
    assert a["step"] == b["step"] and a["scaler"] == b["scaler"]
    assert a["dropout_base"] == b["dropout_base"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
        for k in a["slots"][n]:
            assert torch.equal(a["slots"][n][k], b["slots"][n][k]), (n, k)


# -- the commit protocol ------------------------------------------------------

@pytest.fixture
def saved(tmp_path):
    """A SingleDevice state after one step, committed at step 1."""
    eng = _single(dropout=0.0)
    state = eng.init(0)
    eng.step(state, _batches(1)[0])
    ck.save_checkpoint(tmp_path, state, 1, meta={"model": "tiny"})
    return tmp_path, eng, state


def test_commit_protocol(saved):
    d, eng, state = saved
    assert sorted(os.listdir(d / "step_00000001")) == [
        ck.COMMIT_MARKER, ck.META_FILE, "rank_00000.pt"]
    assert ck.latest_step(d) == 1
    meta = ck.read_meta(d, 1)
    assert meta["engine"] == "SingleDevice" and meta["world"] == 1
    assert meta["model"] == "tiny" and meta["step"] == 1
    assert ck.read_meta(d, 7) is None
    # a tmp dir is never listed; an uncommitted step dir is skipped
    os.makedirs(d / ".tmp_step_00000009")
    os.makedirs(d / "step_00000005")
    assert ck.list_steps(d) == ([1], ["step_00000005"])
    assert ck.latest_step(d) == 1
    with pytest.raises(FileNotFoundError, match="not committed"):
        ck.load_checkpoint(d, eng, step=5)
    with pytest.raises(FileNotFoundError, match="committed steps"):
        ck.load_checkpoint(d, eng, step=4)
    # a committed step is never overwritten
    with pytest.raises(FileExistsError):
        ck.save_checkpoint(d, state, 1)
    # nothing committed: the error names the skipped dirs
    empty = d / "only_partial"
    os.makedirs(empty / "step_00000002")
    with pytest.raises(FileNotFoundError, match="step_00000002"):
        ck.load_checkpoint(empty, eng)


def test_io_hook_retry_and_kill(saved):
    d, eng, state = saved
    calls = []

    def flaky(phase, path, attempt):
        calls.append((phase, attempt))
        if phase == "write" and attempt == 0:
            raise OSError("transient")

    ck.set_io_hook(flaky)
    try:
        ck.save_checkpoint(d, state, 2, backoff=0.0)
        assert calls == [("write", 0), ("write", 1), ("commit", 1)]
        assert ck.latest_step(d) == 2
        # past the bound: the error names the step and the attempts
        ck.set_io_hook(lambda phase, path, attempt: (_ for _ in ()).throw(
            OSError("down")))
        with pytest.raises(RuntimeError, match="after 2 attempt"):
            ck.save_checkpoint(d, state, 3, retries=1, backoff=0.0)

        def killed(phase, path, attempt):
            if phase == "commit":
                raise ck.CheckpointKilled("writer died")

        ck.set_io_hook(killed)
        with pytest.raises(ck.CheckpointKilled):
            ck.save_checkpoint(d, state, 4, backoff=0.0)
    finally:
        ck.set_io_hook(None)
    # the partial dir stays as a kill would leave it, never listed
    assert os.listdir(d / ".tmp_step_00000004") and not os.path.exists(
        d / "step_00000004")
    assert ck.list_steps(d) == ([1, 2], [])
    # the state loads back whole
    back = ck.load_checkpoint(d, _single(dropout=0.0))
    assert back.opt_state["step"] == 1
    assert back.layout["engine"] == "SingleDevice"


# -- SingleDevice: resumed bit for bit, and against JAX ------------------------

def _jax_mask_table(monkeypatch, n_layer, steps):
    """Patch the port's mask draw to return JAX's masks for the same
    places of each engine step: step n's key is fold_in(base, n) on both
    sides (base = fold_in(seed, 0xD0)), then the model's split and
    fold_in tree."""
    import jax
    pbase = prng.fold_in(0, 0xD0)
    jbase = jax.random.fold_in(jax.random.PRNGKey(0), 0xD0)
    table = {}
    for n in range(steps):
        pk = prng.split(prng.fold_in(pbase, n), n_layer + 1)
        jk = jax.random.split(jax.random.fold_in(jbase, n), n_layer + 1)
        table[pk[0]] = jk[0]
        for l in range(n_layer):
            for site in (0, 1):
                table[prng.fold_in(pk[l + 1], site)] = jax.random.fold_in(
                    jk[l + 1], site)

    def keep_mask(key, shape, keep, device, frame=None):
        assert frame is None  # one device
        return torch.from_numpy(np.array(
            jax.random.bernoulli(table[key], keep, tuple(shape))))

    monkeypatch.setattr(gpt2_mod, "_dropout_keep", keep_mask)


def test_single_device_resume_is_bitwise_and_matches_jax(tmp_path,
                                                        monkeypatch):
    import jax
    import jax.numpy as jnp
    from tiny_deepspeed_tpu import AdamW as JAdamW
    from tiny_deepspeed_tpu import SingleDevice as JSingleDevice
    from tiny_deepspeed_tpu import make_mesh
    from tiny_deepspeed_tpu.models.gpt2 import GPT2_PRESETS as JP
    from tiny_deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
    from tiny_deepspeed_tpu.optim import schedule as jsched

    _jax_mask_table(monkeypatch, T.GPT2_PRESETS["tiny"].n_layer, STEPS)
    batches = _batches(STEPS)
    jeng = JSingleDevice(
        JaxGPT2(dataclasses.replace(JP["tiny"], dropout=0.1)),
        JAdamW(lr=jsched.warmup_linear(LR, STEPS, warmup_steps=2),
               weight_decay=0.1),
        mesh=make_mesh(devices=[jax.devices()[0]]), loss_scale="dynamic",
        loss_scale_growth_interval=2)
    jstate = jeng.init(jax.random.PRNGKey(0))
    weights = T.params_from_numpy(
        {n: np.asarray(p) for n, p in jstate.params.items()}, "cpu")
    jl = []
    for x, y in batches:
        jstate, loss = jeng.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jl.append(float(loss))

    def fresh():
        eng = _single()
        state = eng.init(0)
        return eng, eng.load_params(state, weights)

    eng, state = fresh()
    ref = [float(eng.step(state, b)[1]) for b in batches]
    want = _snapshot(eng, state)
    np.testing.assert_allclose(ref, jl, rtol=1e-4)
    assert state.scaler["scale"] > 2.0 ** 15  # grown: every step finite

    eng, state = fresh()
    got = [float(eng.step(state, b)[1]) for b in batches[:SPLIT]]
    ck.save_checkpoint(tmp_path, state, SPLIT)
    eng = _single()  # a new model and engine: no init drawn
    state = ck.load_checkpoint(tmp_path, eng)
    assert state.params["wte"] is eng.model.get_parameter("wte")
    got += [float(eng.step(state, b)[1]) for b in batches[SPLIT:]]
    assert got == ref
    _assert_same(_snapshot(eng, state), want)


def test_refuses_another_optimizer_layout(saved):
    d, _, _ = saved
    model = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    eng = T.SingleDevice(model, T.AdamW(lr=LR, amsgrad=True), device="cpu")
    with pytest.raises(ValueError, match="vmax"):
        ck.load_checkpoint(d, eng)


# -- the distributed engines over gloo ----------------------------------------

ENGINES = ("Zero1", "Zero3")


def _dist_engine(name):
    model = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    return getattr(T, name)(model, T.AdamW(lr=LR, weight_decay=0.1),
                            device="cpu")


def _worker(rank, world, store, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        batches = _batches(STEPS, b=4)
        out = {}
        for name in ENGINES:
            eng = _dist_engine(name)
            state = eng.init(0)
            ref = [float(eng.step(state, b)[1]) for b in batches]
            want = _snapshot(eng, state)
            eng = _dist_engine(name)
            state = eng.init(0)
            got = [float(eng.step(state, b)[1]) for b in batches[:SPLIT]]
            d = os.path.join(out_dir, name)
            ck.save_checkpoint(d, state, SPLIT)
            at_split = eng.gather_params(state)
            eng = _dist_engine(name)
            state = ck.load_checkpoint(d, eng)
            got += [float(eng.step(state, b)[1]) for b in batches[SPLIT:]]
            back = _snapshot(eng, state)
            _assert_same(back, want)
            assert got == ref, (name, got, ref)
            out[name] = {"losses": got, "at_split": at_split}
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


def test_zero1_zero3_data2_resume_bitwise(tmp_path):
    spawn(_worker, 2, tmp_path, timeout=240)
    out = torch.load(tmp_path / "result.pt")
    for name in ENGINES:
        d = tmp_path / name
        assert sorted(f for f in os.listdir(d / "step_00000003")
                      if f.endswith(".pt")) == ["rank_00000.pt",
                                                "rank_00001.pt"]
        meta = json.loads((d / "step_00000003" / ck.META_FILE).read_text())
        assert (meta["engine"], meta["world"], meta["data_size"]) == (
            name, 2, 2)
    # load_params: Zero1's rank-0 params, ZeRO-3's shards joined — each
    # the engine's gathered params at the split
    for name in ENGINES:
        whole = ck.load_params(tmp_path / name)
        want = out[name]["at_split"]
        assert set(whole) == set(want)
        for n in want:
            assert torch.equal(whole[n], want[n]), (name, n)
    with pytest.raises(ValueError, match="world 2"):
        ck.load_checkpoint(tmp_path / "Zero1", _single(dropout=0.0))


def test_refuses_another_world_size(tmp_path, world1):  # noqa: F811
    """A data-2 checkpoint's layout at world 1: refused, naming elastic
    resume."""
    for name in ENGINES:
        d = tmp_path / name / "step_00000003"
        os.makedirs(d)
        eng = _dist_engine(name)
        state = eng.init(0)
        state.layout = dict(state.layout, world=2, data_size=2)
        torch.save(ck._payload(state, state.layout), d / "rank_00000.pt")
        ck._commit(str(d), 3)
        with pytest.raises(ValueError, match="elastic resume"):
            ck.load_checkpoint(tmp_path / name, _dist_engine(name))


# -- the entry points -----------------------------------------------------------

ARGS = ["--device", "cpu", "--model", "tiny", "--seq-len", "32",
        "--batch-per-device", "2", "--lr", "1e-3"]


def _losses(out):
    return [ln for ln in out.splitlines() if " loss " in ln]


def test_train_resume_and_generate_from_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ck")
    state = train_mod.main(ARGS + ["--iters", "6"])
    want = _losses(capsys.readouterr().out)
    assert len(want) == 6
    train_mod.main(ARGS + ["--iters", "3", "--checkpoint-every", "3",
                           "--checkpoint-dir", d])
    first = capsys.readouterr().out
    assert _losses(first) == want[:3] and "saved checkpoint at iter 3" in first
    # the legacy aliases and --checkpoint-sync: a resume that saves at 6
    train_mod.main(ARGS + ["--iters", "6", "--resume", "--save-dir", d,
                           "--save-every", "3", "--checkpoint-sync"])
    second = capsys.readouterr().out
    assert "resumed from" in second and _losses(second) == want[3:]
    assert ck.list_steps(d) == ([3, 6], [])
    assert ck.read_meta(d, 6)["data"] == {
        "global_batch": 2, "indexed": False, "samples_seen": 12, "seed": 0}

    # a changed global batch continues on the indexed stream
    train_mod.main(ARGS[:-4] + ["--batch-per-device", "3", "--lr", "1e-3",
                                "--iters", "7", "--resume",
                                "--checkpoint-dir", d])
    assert "indexed per-sample stream at offset 12" in capsys.readouterr().out

    # generate from the step-6 checkpoint: the tokens of the trained model
    model = T.GPT2Model(T.GPT2_PRESETS["tiny"], device="cpu")
    model.load_state_dict({n: p.detach() for n, p in state.params.items()})
    out = gen_mod.main(["--ckpt", os.path.join(d), "--device", "cpu",
                        "--model", "tiny", "--prompt-tokens", "5,6,7,8",
                        "--max-new-tokens", "6", "--temperature", "0",
                        "--batch", "2"])
    printed = capsys.readouterr().out
    assert "loaded params from" in printed and "tokens/s" in printed
    prompt = torch.tensor([[5, 6, 7, 8]] * 2)
    assert torch.equal(out, model.generate(prompt, 6, temperature=0.0))
