# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""The grad-comm codecs through ZeRO-3's composed schedule and hpZ's
rebuild, against JAX on the CPU over gloo.

Engine level, as tests/test_torch_grad_comm_engines.py holds its cases
(`check_codec_against_jax`: JAX's int8 dither patched in, the tiny
preset at 4 layers, 10 AdamW steps free-running for the losses and
teacher-forced from JAX's state for params, AdamW state and every
rank's residual row; the lowering equal to JAX's):

- Zero3 int8 at data 2 ("composed" through the implicit on-demand gather
  slot: one bucket of every layer through the codec, each rank keeping
  its shard's part; the non-block tail at full precision, no residual
  slice for it);
- Zero3 int8 with `grad_comm_tail="int8"` and `gather_prefetch=2` at
  data 2 (the tail's whole gradients through the codec with their own
  slice);
- Zero3 int8 with `grad_buckets=2` under the fp8 gather (2e-4): each
  fp8 weight's e4m3 cotangent of its codes through the codec, then the
  stacked cast's pullback (e4m3, / scale) on the rank's shard;
- Zero3 hpZ with `hpz_comm` int8 and fp8 at data 4 over two granules of
  two ranks ("composed": the replica rebuilt once a step as codes and
  scales over the inter-granule group).  The payload is each rank's
  resting shards, and the port's ZeRO-3 layout is flat per layer where
  JAX's shards an axis, so the blocks' members — and with them the
  replica's rounding — differ from JAX's: the losses are held (free-
  running and teacher-forced, 1e-4 relative; measured on the CPU within
  3.0e-5 int8, 7.3e-5 fp8), the states are not (the worst forced step
  kept 96.7% of the params within 1e-5 under int8).  What the replica
  is, is held exactly instead: below, every rank's replica equals the
  plain quantizer's rounding of each owner rank's flat shards.

Codec level: `comm.hpz_rebuild` against JAX's `build_sec` payload path
over two granules of two ranks, int8 and fp8, f32 and bf16 rows, bit for
bit; and the engine's replica against its definition (`_replica_check`).

JAX is imported inside the tests: the spawned workers import this module
and must not start JAX.
"""

import os

import numpy as np
import pytest
import torch

import tiny_deepspeed_tpu_torch as T
from tiny_deepspeed_tpu_torch.parallel import comm as C
from test_torch_grad_comm import check_codec_case, run_codec_cases
from test_torch_ring import spawn

L4 = {"n_layer": 4}
GRAN = {0: 0, 1: 0, 2: 1, 3: 1}
INT8 = dict(grad_comm="int8")
FP8 = dict(L4, gather_quant="fp8")


SCHED = {
    "zero3-int8": (2, INT8, L4, None, 1e-5, "composed", False),
    "zero3-int8-tail-prefetch2": (2, dict(INT8, grad_comm_tail="int8",
                                          gather_prefetch=2), L4, None,
                                  1e-5, "composed", True),
    "zero3-hpz-int8-data4": (4, dict(hpz=True, hpz_comm="int8"), L4, GRAN,
                             1e-5, "composed", None),
    "zero3-hpz-fp8-data4": (4, dict(hpz=True, hpz_comm="fp8"), L4, GRAN,
                            2e-4, "composed", None),
    "zero3-fp8-gather-int8-buckets2": (2, dict(INT8, grad_buckets=2), FP8,
                                       None, 2e-4, "composed", False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: one gloo spawn a data size (2 and 4)."""
    return run_codec_cases(tmp_path_factory.mktemp("codec_zero3"), {
        cid: dict(name="Zero3", dp=dp, kw=kw, model_kw=model_kw, atol=atol,
                  hpz_granule_of=gran, states=gran is None)
        for cid, (dp, kw, model_kw, gran, atol, _, _) in SCHED.items()})


@pytest.mark.parametrize("case", list(SCHED))
def test_codec_schedule_matches_jax(runs, case):
    *_, lowering, tail = SCHED[case]
    res, js, jeng = check_codec_case(runs, case)
    assert res["lowering"] == lowering
    lay = jeng._schedule.layout
    if tail is None:  # no grad slot: no residual
        assert "res" not in js
        return
    # the residual row: the buckets' slices, and the tail's where it
    # goes through the codec
    k = lay["n_buckets"]
    assert js["res"].shape[1] == k * lay["bucket_pad"] + (
        lay["tail_pad"] if tail else 0) == jeng._schedule.residual_len


# -- the hpZ rebuild codec ------------------------------------------------------

HPZ_ROWS = {"x": (3, 100), "y": (3, 700)}
HPZ_GRAN = 2


def _replica_check(rank, mode):
    """Zero3 (tiny, 4 layers) with hpZ over two granules and `hpz_comm`:
    the executor's replica of every leaf (L, n_gran, S) equals, slot g,
    the plain quantizer's rounding of the flat shards that rank g * ici +
    i (i this rank's position in its granule) holds — its rows padded to
    S, every leaf's rows in sorted-name order, blocks of 256 — rebuilt
    here from the whole weights."""
    import dataclasses

    from tiny_deepspeed_tpu_torch.ops import quant as qm
    model = T.build_model(dataclasses.replace(T.ALL_PRESETS["tiny"],
                                              n_layer=4), device="cpu")
    eng = T.Zero3(model, T.AdamW(), device="cpu", hpz=True,
                  hpz_granule_of=GRAN, hpz_comm=mode)
    state = eng.init(0)
    whole = eng.gather_params(state)
    g = eng._exec.g
    _, stacked = g.z3.prepare(state.params)
    src = g.begin(stacked)
    names = sorted(k for k in stacked if "#" not in k)
    n, ici = 4, 2
    for slot in range(2):
        owner = slot * ici + rank % ici
        rows = []
        for k in names:
            leaf = g.z3.leaves["h." + k]
            flat = whole["h." + k].reshape(4, -1)
            r = flat.new_zeros(4, leaf.s)
            part = flat[:, owner * leaf.s:(owner + 1) * leaf.s]
            r[:, :part.shape[1]] = part
            rows.append(r)
        payload = torch.cat([r.reshape(-1) for r in rows])
        payload = torch.cat([payload,
                             payload.new_zeros(-payload.numel() % 256)])
        want = qm.dequantize_blockwise(*qm._quantize_plain(payload, mode,
                                                           256))
        off = 0
        for k, r in zip(names, rows):
            got = src[k][:, slot]
            assert torch.equal(got, want[off:off + r.numel()].view_as(r)), \
                (mode, k, slot)
            off += r.numel()
    assert n == eng.n_shard


def _hpz_worker(rank, world, store, out_dir, modes):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        inter = C.new_groups([[0, 2], [1, 3]], rank)
        data = np.load(os.path.join(out_dir, "hpz.npz"))
        for mode in modes:
            _replica_check(rank, mode)
            for dt in (torch.float32, torch.bfloat16):
                rows = {k: torch.from_numpy(data[k][rank]).to(dt)
                        for k in HPZ_ROWS}
                out = C.hpz_rebuild(rows, mode, inter, HPZ_GRAN)
                assert all(out[k].shape == (3, HPZ_GRAN, HPZ_ROWS[k][1])
                           and out[k].dtype == dt for k in out)
                vals = torch.cat([out[k].transpose(0, 1).reshape(
                    HPZ_GRAN, -1).float() for k in sorted(out)], dim=1)
                np.save(os.path.join(out_dir, f"hpz_{mode}_{dt}_{rank}.npy"),
                        vals.numpy())
        dist.barrier()  # no rank tears its groups down before the rest
    finally:
        dist.destroy_process_group()


def test_hpz_rebuild_codec_bit_for_bit_with_jax(tmp_path):
    """JAX's `build_sec` payload path (schedule.py:1880-1903), written
    out with JAX's own codec functions over the inter-granule groups of
    a data-4 mesh in two granules: the port's replica is its dequantized
    values bit for bit, rows in the compute dtype."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from tiny_deepspeed_tpu.parallel import comm as JC
    from tiny_deepspeed_tpu.parallel.schedule import hpz_groups
    n = 4
    _, inter, _, n_gran = hpz_groups({0: 0, 1: 0, 2: 1, 3: 1}, n)
    assert inter == [[0, 2], [1, 3]] and n_gran == HPZ_GRAN
    rng = np.random.default_rng(5)
    data = {k: (rng.standard_normal((n, *s)) * rng.uniform(
        0.01, 3.0, (n, 1, 1))).astype(np.float32) for k, s in HPZ_ROWS.items()}
    np.savez(tmp_path / "hpz.npz", **data)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    modes = ("int8", "fp8")
    spawn(_hpz_worker, n, tmp_path, modes, timeout=120)
    for mode in modes:
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            def local(x, y):
                flat = jnp.concatenate([v[0].astype(jdt).astype(
                    jnp.float32).reshape(-1) for v in (x, y)])
                flat = jnp.concatenate(
                    [flat, jnp.zeros((-flat.shape[0] % 256,), jnp.float32)])
                q, s = JC.quantize_blockwise(flat, mode, 256)
                qg = jax.lax.all_gather(JC.as_wire(q), "data",
                                        axis_index_groups=inter)
                sg = jax.lax.all_gather(s.reshape(1, -1), "data",
                                        axis_index_groups=inter, tiled=True)
                vals = JC._dequant_rows(JC.from_wire(qg, mode),
                                        sg.reshape(n_gran, -1))
                width = sum(int(np.prod(s)) for s in HPZ_ROWS.values())
                return vals[:, :width].astype(jdt).astype(
                    jnp.float32)[None]

            want = np.asarray(jax.shard_map(
                local, mesh=mesh, in_specs=(P("data"),) * 2,
                out_specs=P("data"), check_vma=False)(
                    jnp.asarray(data["x"]), jnp.asarray(data["y"])))
            for r in range(n):
                got = np.load(tmp_path / f"hpz_{mode}_{dt}_{r}.npy")
                np.testing.assert_array_equal(got, want[r],
                                              err_msg=f"{mode} {dt} rank {r}")


