# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The grad-comm codecs (parallel/comm.py) against JAX's, bit for bit, on
the CPU; the pure geometry, the wire models and `auto_comm_plan` against
JAX's.

Codec level: each case hands both sides the same random inputs, made
from a seed with numpy — every rank's two leaves, its residual row, a
flat vector for the reduce-scatter alone and a chunk for the all-gather
alone — and, for int8, JAX's own dither: the parent draws JAX's
`uniform(split(fold_in(fold_in(PRNGKey(0x6C51), step), rank)))` for the
reduce-scatter and the all-gather and writes them to an .npz; the port's
workers (gloo, one process a rank, one world for every case of a rank
count) replace `comm.draw_dither` with a lookup in it.  JAX runs its
functions op by op inside a `shard_map` over a CPU mesh of the same
size.  Pinned:
`quantized_grad_sync` (reduced leaves and new residual on every rank),
`quantized_reduce_scatter` and `quantized_all_gather` alone, equal as
floats; at data 2 and data 4 (the rank-order sum of the dequantized
rows), int8 and fp8, error feedback on and off (fp8 at data 4 without
it), the 2-hop schedule
(inner 2 at data 4: hop 1 in codes within pairs, hop 2 in bf16 across
them, the all-gather's rows re-ordered by `piece_owner`), and an inf in
one rank's gradient (the residual scrubbed to JAX's, the reduced values
non-finite where JAX's are).  The hpZ rebuild codec is held in
tests/test_torch_grad_comm_zero3.py.

Engine-level trajectories: tests/test_torch_grad_comm_engines.py and
tests/test_torch_grad_comm_zero3.py, through `check_codec_against_jax`
here (the dither table; the free-running losses, and every step
teacher-forced from JAX's state: params, AdamW state and the residual
held to the 99% rule).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import dataclasses
import os
import types
import zlib

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.parallel import comm as C
from test_torch_ring import spawn

BLOCK = 256
STEP = 3
SHAPES = {"a": (10, 100), "b": (2000,)}
TOTAL = sum(int(np.prod(s)) for s in SHAPES.values())

# (id, ranks, mode, error feedback, inner, an inf in rank 1's gradient)
CASES = [
    ("d2-int8-ef", 2, "int8", True, None, False),
    ("d2-fp8-ef", 2, "fp8", True, None, False),
    ("d2-int8-ef-inf", 2, "int8", True, None, True),
    ("d4-int8-ef", 4, "int8", True, None, False),
    ("d4-fp8-noef", 4, "fp8", False, None, False),
    ("d4-int8-ef-2hop", 4, "int8", True, 2, False),
    ("d4-fp8-ef-2hop", 4, "fp8", True, 2, False),
]


def _site(site):
    return "m" if site is None else f"{site[0]}of{site[1]}"


def dither_key(step, rank, site, hop):
    return f"{step}_{rank}_{_site(site)}_{hop}"


def table_draw(path):
    """A `comm.draw_dither` that returns the draws of the table at `path`
    (written by `jax_dither_table`)."""
    table = np.load(path)

    def draw(step, rank, site, hop, n, device):
        a = table[dither_key(step, rank, site, hop)]
        assert a.shape == (n,), (a.shape, n)
        return torch.from_numpy(a).to(device)
    return draw


def jax_dither_table(path, steps, n, sites):
    """JAX's int8 dither of every (step, rank, site, hop): `sites` is
    [(site, padded flat length)], site None for the monolithic sync or
    (b, K) for bucket b of K (b == K: the tail) — JAX's key tree
    (schedule.py:1324-1343, :1484-1493; comm.py:302-304)."""
    import jax
    import jax.numpy as jnp
    out = {}
    base = jax.random.PRNGKey(0x6C51)
    for step in steps:
        ks = jax.random.fold_in(base, step)
        for d in range(n):
            kd = jax.random.fold_in(ks, d)
            for site, e in sites:
                k = kd if site is None else \
                    jax.random.split(kd, site[1] + 1)[site[0]]
                rs, ag = jax.random.split(k)
                for hop, key, m in (("rs", rs, e), ("ag", ag, e // n)):
                    out[dither_key(step, d, site, hop)] = np.asarray(
                        jax.random.uniform(key, (m,), jnp.float32, -0.5,
                                           0.5))
    np.savez(path, **out)


# -- the engine level: the shared check ----------------------------------------

def _load_jax_state(engine, state, npz, rank):
    """Overwrite the port's state with JAX's state of one step (whole
    leaves in `npz`): params, AdamW moments as this rank holds them, the
    step counter, the scaler and this rank's residual row."""
    params = {k[2:]: torch.from_numpy(npz[k]) for k in npz.files
              if k.startswith("p:")}
    engine.load_params(state, T.params_from_numpy(
        {n: t.numpy() for n, t in params.items()}, "cpu"))
    opt = state.opt_state
    opt["step"] = int(npz["step"])
    with torch.no_grad():
        for n, slots in opt["state"].items():
            for k, t in slots.items():
                whole = torch.from_numpy(npz[f"{k}:{n}"])
                if engine.stage >= 3:
                    part = engine._z3.shard(n, whole)
                elif engine.stage >= 1:
                    part = engine._own(n, whole)
                else:
                    part = whole
                t.copy_(part.reshape(t.shape))
        if state.grad_residual is not None:
            state.grad_residual.copy_(torch.from_numpy(npz["res"][rank]))
    if state.scaler is not None:
        state.scaler = {"scale": float(npz["scale"]),
                        "good": int(npz["good"])}


def _codec_engine_worker(rank, world, store, base, cases):
    """One gloo rank running each case in turn (one spawn serving several
    checks), case `cid`'s files under `base/cid`: `_codec_case`."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    draw = C.draw_dither
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        for cid, args in cases:
            out_dir = os.path.join(base, cid)
            table = os.path.join(out_dir, "dither.npz")
            C.draw_dither = (table_draw(table) if os.path.exists(table)
                             else draw)
            _codec_case(rank, world, out_dir, *args)
            dist.barrier()  # no rank tears its groups down before the rest
    finally:
        C.draw_dither = draw
        dist.destroy_process_group()


def _codec_case(rank, world, out_dir, name, kw, accum, overflow, model_kw,
                preset, steps):
    """One case on this rank, JAX's dither patched in (when the case has
    a table): `name` free-running over the global batches from JAX's init
    (the losses), then step t again from JAX's state before step t, for
    every t (teacher-forced).  Rank 0 saves the free-running losses, and
    per forced step the loss, the whole params, AdamW state, scaler and
    every rank's residual row after it."""
    import dataclasses

    import torch.distributed as dist
    from test_torch_dist import _batches, _optimizer, _overflow
    model = T.build_model(dataclasses.replace(T.ALL_PRESETS[preset],
                                              **(model_kw or {})),
                          device="cpu")
    engine = getattr(T, name)(model, _optimizer("adamw"), device="cpu",
                              accum_steps=accum, **kw)
    state = engine.init(0)
    ref = np.load(os.path.join(out_dir, "params.npz"))
    engine.load_params(state, T.params_from_numpy(dict(ref), "cpu"))
    if overflow:
        _overflow(state, state.params)
    batches = _batches(steps, accum)
    free = [float(engine.step(state, b)[1]) for b in batches]
    forced = []
    for t, batch in enumerate(batches):
        _load_jax_state(engine, state,
                        np.load(os.path.join(out_dir, f"jax{t}.npz")), rank)
        state, loss = engine.step(state, batch)
        res = None
        if state.grad_residual is not None:
            rows = [torch.empty_like(state.grad_residual)
                    for _ in range(world)]
            dist.all_gather(rows, state.grad_residual)
            res = torch.stack(rows)
        forced.append({"loss": float(loss),
                       "params": engine.gather_params(state),
                       "opt": engine.gather_opt_state(state),
                       "scaler": state.scaler, "residual": res})
    if rank == 0:
        torch.save({"free": free, "forced": forced,
                    "describe": engine.describe(),
                    "lowering": engine._schedule.lowering},
                   os.path.join(out_dir, "result.pt"))


def _jax_codec_run(tmp_path, name, dp, kw, accum, overflow, model_kw,
                   preset, steps):
    """JAX's engine on a CPU mesh of `dp`: its init written for the port,
    its state before every step t written to jax{t}.npz; returns (the
    losses, the states after each step, the engine, each element's least
    bias-corrected gradient RMS over the steps)."""
    import jax
    import jax.numpy as jnp
    import tiny_deepspeed_tpu as J
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    from test_torch_dist import LR, _batches
    mesh = J.make_mesh((dp,), ("data",), devices=jax.devices()[:dp])
    jopt = J.AdamW(lr=LR, weight_decay=0.1)
    jcfg = dataclasses.replace(JP[preset], **(model_kw or {}))
    jeng = getattr(J, name)(jbuild(jcfg), jopt, mesh=mesh,
                            accum_steps=accum, **kw)
    state = jeng.init(jax.random.PRNGKey(0))
    np.savez(tmp_path / "params.npz",
             **{n: np.asarray(p) for n, p in state.params.items()})
    if overflow:
        state = state.replace(
            scaler={"scale": jnp.float32(2.0 ** 127),
                    "good": jnp.int32(0)},
            params=dict(state.params,
                        **{"lm_head.w": state.params["lm_head.w"] * 40}))

    def snap(st):
        """The state as numpy (the step donates its input's buffers)."""
        out = {f"p:{n}": np.asarray(p) for n, p in st.params.items()}
        for n, slots in st.opt_state["state"].items():
            out.update({f"{k}:{n}": np.asarray(t) for k, t in slots.items()})
        out["step"] = np.asarray(st.opt_state["step"])
        if st.grad_residual is not None:
            out["res"] = np.asarray(st.grad_residual)
        if st.scaler is not None:
            out["scale"] = np.asarray(st.scaler["scale"])
            out["good"] = np.asarray(st.scaler["good"])
        return out

    losses, states = [], []
    rms = {n: np.inf for n in state.params}
    for t, (x, y) in enumerate(_batches(steps, accum)):
        np.savez(tmp_path / f"jax{t}.npz", **snap(state))
        state, loss = jeng.step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(loss))
        states.append(snap(state))
        k = int(states[-1]["step"])
        if k:
            for n in rms:
                v = states[-1][f"v:{n}"]
                rms[n] = np.minimum(rms[n], np.sqrt(v / (1 - jopt.b2 ** k)))
    return np.asarray(losses), states, jeng, rms


def _dither_sites(jeng, n):
    """The (site, padded length) of every int8 sync JAX's engine runs a
    step, from its schedule; [] when none dithers."""
    js = jeng._schedule
    g = js.grad
    if g is None or "int8" not in (g.mode, g.tail_mode):
        return []
    if js.lowering == "quant_mono":
        total = sum(C.numel(s) for s in jeng.model.param_shapes().values())
        return [(None, C.padded_size(total, n, g.block))]
    lay = js.layout
    k = lay["n_buckets"]
    sites = [((b, k), lay["bucket_pad"]) for b in range(k)]
    if lay["tail_pad"]:
        sites.append(((k, k), lay["tail_pad"]))
    return sites


def _held(got, want, keep, atol):
    """(held elements, of them within atol)."""
    ok = keep & (np.abs(got - want) <= atol)
    return keep.sum(), ok.sum()


def check_codec_against_jax(tmp_path, name, dp, kw, accum=1, overflow=False,
                            model_kw=None, atol=1e-5, preset="tiny",
                            hpz_granule_of=None, states=True):
    """`name` with the codec knobs `kw` on the port over `dp` gloo ranks
    (JAX's int8 dither patched in) and on JAX over a CPU mesh of `dp`.

    A codec's output is a step function of its input: the roundoff by
    which torch's and XLA's local gradients differ flips a code now and
    then, and a flipped code near zero moves Adam's normalized step by up
    to lr, which the next steps amplify.  So the free-running port is held
    to JAX's losses (1e-4 relative), and every step's state is held
    teacher-forced: step t runs from JAX's state before it (params, AdamW
    moments, counter, scaler, residual) and its result is compared with
    JAX's after it — loss to 1e-4 relative; params and AdamW state to
    `atol` on at least 99% of the elements whose gradient RMS stayed at
    or above RMS_FLOOR (tests/test_torch_dist.py), those at least 99% of
    all; every rank's residual row to `atol` on at least 99% of its
    elements.  `hpz_granule_of` goes to both engines.  `states=False`
    holds the losses (free-running and forced), counters and scaler only:
    for a forward whose weights the port rounds in other blocks than JAX
    does (hpZ's rebuild codec over the port's flat shard layout).
    Returns (the port's result, JAX's final state as numpy, engine)."""
    runs = run_codec_cases(tmp_path, {"": dict(
        name=name, dp=dp, kw=kw, accum=accum, overflow=overflow,
        model_kw=model_kw, atol=atol, preset=preset,
        hpz_granule_of=hpz_granule_of, states=states)})
    return check_codec_case(runs, "")


def run_codec_cases(tmp_path, cases):
    """Each case — {id: check_codec_against_jax's arguments as a dict} —
    on JAX (its files under tmp_path/id), then every case of one `dp` in
    one gloo spawn: {id: (the port's result, JAX's losses, states after
    each step, engine, least gradient RMS per element, the case)}.  A
    module-scoped fixture over it serves each case's test."""
    from test_torch_dist import STEPS
    out, by_dp = {}, {}
    for cid, c in cases.items():
        c = dict(dict(accum=1, overflow=False, model_kw=None, atol=1e-5,
                      preset="tiny", hpz_granule_of=None, states=True), **c)
        kw = dict(c["kw"])
        if c["hpz_granule_of"] is not None:
            kw["hpz_granule_of"] = c["hpz_granule_of"]
        steps = STEPS if not c["overflow"] else 4
        d = tmp_path / cid
        d.mkdir(exist_ok=True)
        jl, jstates, jeng, rms = _jax_codec_run(
            d, c["name"], c["dp"], kw, c["accum"], c["overflow"],
            c["model_kw"], c["preset"], steps)
        sites = _dither_sites(jeng, c["dp"])
        if sites:
            jax_dither_table(d / "dither.npz", range(steps), c["dp"], sites)
        by_dp.setdefault(c["dp"], []).append((cid, (
            c["name"], kw, c["accum"], c["overflow"], c["model_kw"],
            c["preset"], steps)))
        out[cid] = (jl, jstates, jeng, rms, c)
    for dp, todo in by_dp.items():
        spawn(_codec_engine_worker, dp, tmp_path, todo,
              timeout=120 + 60 * len(todo))
    return {cid: (torch.load(tmp_path / cid / "result.pt"), *v)
            for cid, v in out.items()}


def check_codec_case(runs, cid):
    """`check_codec_against_jax`'s comparison of case `cid` of
    `run_codec_cases`: (the port's result, JAX's final state, engine)."""
    from test_torch_dist import RMS_FLOOR
    res, jl, jstates, jeng, rms, c = runs[cid]
    atol, states = c["atol"], c["states"]
    assert res["lowering"] == jeng._schedule.lowering, res["lowering"]
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(res["free"]), fin)
    np.testing.assert_allclose(np.asarray(res["free"])[fin], jl[fin],
                               rtol=1e-4)
    bc = jeng.optimizer
    for t, (got, js) in enumerate(zip(res["forced"], jstates)):
        assert np.isfinite(got["loss"]) == np.isfinite(jl[t]), t
        if np.isfinite(jl[t]):
            np.testing.assert_allclose(got["loss"], jl[t], rtol=1e-4)
        k = int(js["step"])
        assert got["opt"]["step"] == k, (t, got["opt"]["step"], k)
        if "scale" in js:
            assert got["scaler"]["scale"] == float(js["scale"])
            assert got["scaler"]["good"] == int(js["good"])
        jres = js.get("res")
        assert (got["residual"] is None) == (jres is None)
        if not states:
            continue
        if jres is not None:
            g, w = got["residual"].numpy(), jres
            assert g.shape == w.shape
            assert (np.abs(g - w) <= atol).mean() >= 0.99, t
        held = close = total = 0
        for n, p in got["params"].items():
            keep = np.broadcast_to(rms[n] >= RMS_FLOOR, p.shape)
            slots = got["opt"]["state"][n]
            pairs = [(p.numpy(), js[f"p:{n}"]),
                     (slots["m"].numpy(), js[f"m:{n}"])]
            if k:
                b2 = 1 - bc.b2 ** k
                pairs.append(tuple(np.sqrt(x / b2) for x in (
                    slots["v"].numpy(), js[f"v:{n}"])))
            ok = keep.copy()
            for a, b in pairs:
                ok &= np.abs(a - b) <= atol
            held += keep.sum()
            close += ok.sum()
            total += p.numel()
        assert held >= 0.99 * total, (t, held / total)
        assert close >= 0.99 * held, (t, close / held)
    return res, jstates[-1], jeng


# -- the codec level ----------------------------------------------------------

def _inputs(cid, n, inf):
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    e_pad = C.padded_size(TOTAL, n, BLOCK)
    scale = rng.uniform(0.1, 10.0, (n, 1))
    data = {k: (rng.standard_normal((n, *s)) * scale.reshape(
        (n,) + (1,) * len(s))).astype(np.float32) for k, s in SHAPES.items()}
    if inf:
        data["b"][1, 777] = np.inf
    data["res"] = (rng.standard_normal((n, e_pad)) * 1e-2).astype(np.float32)
    data["fr"] = rng.standard_normal((n, e_pad)).astype(np.float32)
    data["ch"] = rng.standard_normal((n, e_pad // n)).astype(np.float32)
    return data


def _jax_codec(n, mode, ef, inner, data):
    """JAX's three functions inside a shard_map over `n` CPU devices, run
    op by op (not under jit, where XLA:CPU contracts the dequantize's
    products and the rank sum into FMAs, an ulp from the IEEE ops):
    per rank (reduced a, reduced b, new residual, RS chunk, AG whole)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from tiny_deepspeed_tpu.parallel import comm as JC
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    base = jax.random.fold_in(jax.random.PRNGKey(0x6C51), STEP)

    def local(a, b, res, fr, ch):
        key = (jax.random.fold_in(base, jax.lax.axis_index("data"))
               if mode == "int8" else None)
        red, nres = JC.quantized_grad_sync(
            {"a": a[0], "b": b[0]}, res[0] if ef else None, "data", n, mode,
            block=BLOCK, rng=key, inner=inner)
        krs = kag = None
        if key is not None:
            krs, kag = jax.random.split(key)
        chunk = JC.quantized_reduce_scatter(fr[0], "data", n, mode,
                                            block=BLOCK, rng=krs,
                                            inner=inner)
        whole = JC.quantized_all_gather(ch[0], "data", n, mode, block=BLOCK,
                                        rng=kag, inner=inner)
        nres = nres if ef else jnp.zeros_like(res[0])
        return (red["a"][None], red["b"][None], nres[None], chunk[None],
                whole[None])

    args = [jnp.asarray(data[k]) for k in ("a", "b", "res", "fr", "ch")]
    out = jax.shard_map(local, mesh=mesh, in_specs=(P("data"),) * 5,
                        out_specs=(P("data"),) * 5, check_vma=False)(*args)
    return dict(zip(("a", "b", "res", "chunk", "whole"),
                    (np.asarray(o) for o in out)))


def _codec_worker(rank, world, store, out_dir, cases):
    """One gloo rank: every case of this rank count through the port's
    codec, JAX's dither patched in; each rank saves its outputs."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        for cid, n, mode, ef, inner, _ in cases:
            data = np.load(os.path.join(out_dir, f"{cid}.npz"))
            C.draw_dither = table_draw(os.path.join(out_dir,
                                                    f"{cid}_dither.npz"))
            hops = None
            if inner:
                intra, inter = C._hier_groups(n, inner)
                hops = (C.new_groups(intra, rank), C.new_groups(inter, rank))
            t = {k: torch.from_numpy(data[k][rank]) for k in data.files}
            group = dist.group.WORLD
            key = C.SyncKey(STEP, rank) if mode == "int8" else None
            red, nres = C.quantized_grad_sync(
                {"b": t["b"], "a": t["a"]}, t["res"] if ef else None, group,
                n, mode, block=BLOCK, key=key, inner=inner, hops=hops)
            drs = dag = None
            if key is not None:
                e_pad = t["fr"].numel()
                drs = C.draw_dither(STEP, rank, None, "rs", e_pad, "cpu")
                dag = C.draw_dither(STEP, rank, None, "ag", e_pad // n,
                                    "cpu")
            chunk = C.quantized_reduce_scatter(
                t["fr"], group, n, mode, block=BLOCK, dither=drs,
                inner=inner, hops=hops)
            whole = C.quantized_all_gather(t["ch"], group, n, mode,
                                           block=BLOCK, dither=dag,
                                           inner=inner)
            np.savez(os.path.join(out_dir, f"{cid}_port{rank}.npz"),
                     a=red["a"].numpy(), b=red["b"].numpy(),
                     res=(nres if ef else torch.zeros_like(t["res"])).numpy(),
                     chunk=chunk.numpy(), whole=whole.numpy(),
                     dtypes=np.array([str(red["a"].dtype),
                                      str(red["b"].dtype)]))
        dist.barrier()  # no rank tears its groups down before the rest
    finally:
        dist.destroy_process_group()


def _same(got, want, what):
    """Bit for bit as floats (NaN where JAX has NaN); where JAX's value is
    not finite, the port's is not either."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[fin], want[fin], err_msg=what)


@pytest.mark.parametrize("n", [2, 4])
def test_codec_bit_for_bit_with_jax(tmp_path, n):
    cases = [c for c in CASES if c[1] == n]
    want = {}
    for cid, _, mode, ef, inner, inf in cases:
        data = _inputs(cid, n, inf)
        np.savez(tmp_path / f"{cid}.npz", **data)
        jax_dither_table(tmp_path / f"{cid}_dither.npz", [STEP], n,
                         [(None, C.padded_size(TOTAL, n, BLOCK))])
        want[cid] = _jax_codec(n, mode, ef, inner, data)
    spawn(_codec_worker, n, tmp_path, cases, timeout=120)
    for cid, _, mode, ef, inner, inf in cases:
        w = want[cid]
        for r in range(n):
            got = np.load(tmp_path / f"{cid}_port{r}.npz")
            assert list(got["dtypes"]) == ["torch.float32"] * 2
            for k in ("a", "b", "chunk", "whole"):
                _same(got[k], w[k][r], f"{cid} rank {r} {k}")
            # the residual: bit for bit, the scrubbed element included
            np.testing.assert_array_equal(got["res"], w["res"][r],
                                          err_msg=f"{cid} rank {r} res")
        if inf:
            assert not np.isfinite(w["b"][0]).all()
            assert w["res"][1, SHAPES["a"][0] * SHAPES["a"][1] + 777] == 0
        else:
            assert all(np.isfinite(w[k]).all() for k in w)


# -- the pure geometry, the wire models, the "auto" plan -------------------

def test_geometry_equals_jax():
    from tiny_deepspeed_tpu.parallel import comm as JC
    for e in (1, 255, 256, 3000, 163_109_376):
        for n in (1, 2, 4, 8):
            for block in (128, 256):
                assert C.padded_size(e, n, block) == \
                    JC.padded_size(e, n, block)
    for n, inner in ((4, 2), (8, 2), (8, 4), (4, None), (4, 4), (2, 1)):
        assert np.array_equal(C.piece_owner(n, inner),
                              JC.piece_owner(n, inner)), (n, inner)
        if inner and n % inner == 0:
            assert C._hier_groups(n, inner) == JC._hier_groups(n, inner)
    for bad in ((4, 3), (6, 4)):
        with pytest.raises(ValueError, match="must divide"):
            C.piece_owner(*bad)
        with pytest.raises(ValueError, match="must divide"):
            JC.piece_owner(*bad)


def _port_shapes(preset):
    """(the port's param shapes of `preset`, its n_layer), no weights."""
    cfg = T.ALL_PRESETS[preset]
    return (T.GPT2Model.param_shapes(types.SimpleNamespace(config=cfg)),
            cfg.n_layer)


@pytest.mark.parametrize("preset", ["tiny", "gpt2-124m"])
def test_bucket_layout_and_wire_models_equal_jax(preset):
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    from tiny_deepspeed_tpu.parallel import comm as JC
    jm = jbuild(JP[preset])
    shapes, L = _port_shapes(preset)
    for k in (1, 2, L):
        for n in (1, 2, 4, 8):
            for block in (256, 512):
                assert C.bucket_layout(shapes, L, k, n, block) \
                    == JC.bucket_layout(jm.param_shapes(), L, k, n, block)
    total = sum(C.numel(s) for s in shapes.values())
    for n in (1, 2, 4, 8):
        for inner in (None, 2) if n > 2 else (None,):
            for mode in ("int8", "fp8"):
                assert C.modeled_wire_bytes(total, n, mode, inner=inner) \
                    == JC.modeled_wire_bytes(total, n, mode, inner=inner)
            assert C.modeled_gather_wire_bytes(7 * total, 2 * total, n,
                                               inner) == \
                JC.modeled_gather_wire_bytes(7 * total, 2 * total, n, inner)
        for mode in ("fp32", "int8", "fp8"):
            assert C.modeled_hpz_rebuild_bytes(2 * total, total, n, mode) \
                == JC.modeled_hpz_rebuild_bytes(2 * total, total, n, mode)


@pytest.mark.parametrize("preset", ["tiny", "gpt2-124m"])
def test_auto_comm_plan_equals_jax(preset):
    """`auto_comm_plan` on a grid of geometries: n_shard 1/2/4/8 over one
    granule (no map) or two, both presets' shapes (also none)."""
    from tiny_deepspeed_tpu.models import ALL_PRESETS as JP
    from tiny_deepspeed_tpu.models import build_model as jbuild
    from tiny_deepspeed_tpu.parallel import schedule as JS
    from tiny_deepspeed_tpu_torch.parallel import schedule as S
    jm = jbuild(JP[preset])
    tshapes, L = _port_shapes(preset)
    seen = set()
    for n in (1, 2, 4, 8):
        for gmap in (None, {r: r * 2 // n for r in range(n)}):
            for shapes in ((jm.param_shapes(), tshapes),
                           (None, None)):
                for kw in ({}, dict(max_buckets=4, overhead_tol=0.02)):
                    want = JS.auto_comm_plan(n_shard=n, n_layer=L,
                                             shapes=shapes[0],
                                             granule_of=gmap, **kw)
                    got = S.auto_comm_plan(n_shard=n, n_layer=L,
                                           shapes=shapes[1],
                                           granule_of=gmap, **kw)
                    assert got == want, (n, gmap, kw)
                    seen.add((want["grad_comm"], want["grad_buckets"],
                              want["gather_inner"]))
    assert len(seen) >= 3  # the grid reaches several plans
    plan = dict(want, grad_comm_tail="int8", hpz=None)
    assert S.comm_plan_engine_kwargs(plan) == \
        JS.comm_plan_engine_kwargs(plan)
    assert S.COMM_PLAN_KEYS == JS.COMM_PLAN_KEYS
