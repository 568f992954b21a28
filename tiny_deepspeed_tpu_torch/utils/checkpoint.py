# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Checkpoint and resume of a training run, atomic and per rank.

Counterpart of `tiny_deepspeed_tpu/utils/checkpoint.py` (:65-365): the
same API and guarantees in the port's own format.

    save_checkpoint(dir, state, step, meta={...})
    state = load_checkpoint(dir, engine, step=None)     # None -> latest
    params = load_params(dir)                           # whole, any engine

Layout of one step: `dir/step_XXXXXXXX/` holds `rank_XXXXX.pt` per rank
(`torch.save` of what that rank holds of its `TrainState`: the params —
ZeRO-3's shards under Zero3 — the optimizer state as the rank holds it,
`scaler`, `dropout_base`, the grad-comm codec's error-feedback
residual row `grad_residual` and the engine's `layout`, the model's whole
param shapes in it), the JSON sidecar `ckpt_meta.json` and the `COMMITTED`
marker.

- Atomic commit: every rank writes into `.tmp_step_XXXXXXXX`, a barrier,
  then rank 0 renames it to `step_XXXXXXXX` and drops `COMMITTED`.  A
  reader never sees a half-written step under its final name; a crash
  between rename and marker leaves a dir that `latest_step` skips and
  the errors name.
- A committed step is never overwritten (`FileExistsError`).
- Bounded retry: a failed attempt is retried with exponential backoff on
  a single process; across processes a rank retrying alone would leave
  the others in a barrier, so a multi-rank save fails fast (JAX
  :189-195) and the job's restart is the retry.
- The sidecar holds the layout (engine, world, data and seq sizes) and
  whatever the caller adds (`train.py`: the model preset and the data
  offset — global batch, samples seen, indexed stream).
- Load reads the rank's file with `torch.load(weights_only=True)` straight
  onto the engine's device, checks every name, shape and dtype against
  the engine's `state_target`, and builds the state with
  `engine.restore` — no init is drawn.  A checkpoint written at another
  world size, by another engine or in another shard layout is refused:
  elastic resume (JAX `resilience/elastic.py`) is not ported yet.

Fault injection: `set_io_hook(fn)` installs `fn(phase, path, attempt)`,
called at "write" (before the payload) and "commit" (after it, before
the rename) in every process; raising fails that attempt (retried), and
`CheckpointKilled` aborts the save outright, leaving the partial dir as
a real kill would.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

COMMIT_MARKER = "COMMITTED"
META_FILE = "ckpt_meta.json"
# the layout keys two states must share to load one into the other
_LAYOUT_KEYS = ("engine", "stage", "world", "data_size", "seq_size")


class CheckpointKilled(RuntimeError):
    """Raised by a fault-injection hook to simulate the writer dying
    mid-save.  Never retried: the partially written state on disk must
    look exactly like a real preemption's."""


_io_hook: Optional[Callable] = None


def set_io_hook(fn: Optional[Callable]) -> None:
    """Install (or clear, with None) the save path's fault-injection hook
    `fn(phase, path, attempt)`, phase "write" or "commit"."""
    global _io_hook
    _io_hook = fn


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def _rank_file(path: str, rank: int) -> str:
    return os.path.join(path, f"rank_{rank:05d}.pt")


def _is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def list_steps(directory: str) -> Tuple[List[int], List[str]]:
    """(committed step numbers ascending, skipped dir names): a dir counts
    only when its name parses as `step_<int>` and it holds the commit
    marker; every other `step_*` dir is reported as skipped."""
    if not os.path.isdir(directory):
        return [], []
    committed, skipped = [], []
    for name in sorted(os.listdir(directory)):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            skipped.append(name)
            continue
        if _is_committed(os.path.join(directory, name)):
            committed.append(step)
        else:
            skipped.append(name)
    return sorted(committed), skipped


def latest_step(directory: str) -> Optional[int]:
    """The largest committed step, or None; uncommitted dirs are
    skipped."""
    committed, _ = list_steps(directory)
    return committed[-1] if committed else None


def read_meta(directory: str, step: int) -> Optional[dict]:
    """The step's JSON sidecar, or None (absent or unreadable)."""
    try:
        with open(os.path.join(_step_dir(directory, step), META_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _barrier(world: int) -> None:
    if world > 1:
        dist.barrier()


def _with_retries(fn, what: str, *, retries: int, backoff: float):
    """`fn(attempt)` with bounded attempts and `backoff * 2**attempt`
    sleeps between them; CheckpointKilled propagates untouched, and the
    last failure becomes a RuntimeError naming `what`."""
    attempts = int(retries) + 1
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn(attempt)
        except CheckpointKilled:
            raise
        except Exception as e:  # transient I/O: back off and retry
            last = e
            if attempt < attempts - 1:
                time.sleep(backoff * (2 ** attempt))
    raise RuntimeError(f"{what} failed after {attempts} attempt(s); last "
                       f"error: {last!r}") from last


def _commit(path: str, step: int) -> None:
    with open(os.path.join(path, COMMIT_MARKER), "w") as f:
        f.write(f"step={step}\nts={time.time()}\n")


def _payload(state, layout) -> Dict:
    """What this rank writes: plain dicts of tensors and numbers, which
    `torch.load(weights_only=True)` reads back."""
    opt = state.opt_state
    return {"layout": dict(layout),
            "params": {n: p.detach() for n, p in state.params.items()},
            "opt_state": {"step": int(opt["step"]),
                          "state": {n: {k: t.detach() for k, t in s.items()}
                                    for n, s in opt["state"].items()}},
            "scaler": None if state.scaler is None else dict(state.scaler),
            "dropout_base": state.dropout_base,
            "grad_residual": (None if state.grad_residual is None
                              else state.grad_residual.detach())}


def save_checkpoint(directory: str, state, step: int, *,
                    meta: Optional[dict] = None, retries: int = 3,
                    backoff: float = 0.5) -> str:
    """Write `state` (a TrainState from `engine.init`, `engine.step` or
    `load_checkpoint`: it carries its layout) at `step`, atomically: every
    rank its own file into the tmp dir, then rename and marker.  Every
    rank of the run calls it.  `meta` goes into the JSON sidecar beside
    the layout.  Returns the step's path."""
    layout = state.layout
    if layout is None:
        raise ValueError("save_checkpoint: the state carries no layout; "
                         "save a TrainState from an engine")
    world, rank = int(layout["world"]), int(layout["rank"])
    lead = rank == 0
    directory = os.path.abspath(directory)
    if lead:
        os.makedirs(directory, exist_ok=True)
    path = _step_dir(directory, step)
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    if _is_committed(path):
        raise FileExistsError(
            f"checkpoint step {step} already committed at {path}; delete "
            "it first to re-save this step")
    if world > 1:
        retries = 0  # a rank retrying alone would hang the barriers
    payload = _payload(state, layout)

    def attempt(n):
        if os.path.exists(path):
            if _is_committed(path) and n > 0:
                return path  # an earlier attempt of this call committed
            # an uncommitted dir at the final name cannot be trusted
            if lead:
                shutil.rmtree(path, ignore_errors=True)
        if _io_hook is not None:
            _io_hook("write", tmp, n)
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier(world)
        torch.save(payload, _rank_file(tmp, rank))
        if lead:
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump({**{k: layout[k] for k in _LAYOUT_KEYS},
                           "step": int(step), **(meta or {})},
                          f, indent=1, sort_keys=True)
        if _io_hook is not None:
            _io_hook("commit", tmp, n)
        _barrier(world)
        if lead:
            os.rename(tmp, path)
            _commit(path, step)
        _barrier(world)
        return path

    return _with_retries(attempt, f"checkpoint save of step {step} to "
                         f"{path}", retries=retries, backoff=backoff)


def _resolve_step(directory: str, step: Optional[int]) -> int:
    committed, skipped = list_steps(directory)
    if step is None:
        if not committed:
            extra = (f" (skipped uncommitted dirs: {skipped} — a crashed "
                     "writer's leavings; delete them or re-save)"
                     if skipped else "")
            raise FileNotFoundError(
                f"no committed checkpoints under {directory}{extra}")
        return committed[-1]
    if step not in committed:
        if os.path.isdir(_step_dir(directory, step)):
            raise FileNotFoundError(
                f"checkpoint step {step} under {directory} exists but is "
                f"not committed (no {COMMIT_MARKER} marker: the writer "
                f"likely died mid-save); committed steps: {committed}")
        raise FileNotFoundError(f"no checkpoint step {step} under "
                                f"{directory}; committed steps: {committed}")
    return step


def _read(path: str, rank: int, device, retries: int, backoff: float,
          world: int):
    f = _rank_file(path, rank)
    if not os.path.exists(f):
        raise ValueError(f"checkpoint {path} holds no file for rank {rank}")
    return _with_retries(
        lambda n: torch.load(f, map_location=device, weights_only=True),
        f"checkpoint read of {f}", retries=0 if world > 1 else retries,
        backoff=backoff)


def _describe(lay) -> str:
    return (f"{lay['engine']} (ZeRO stage {lay['stage']}) at world "
            f"{lay['world']} (data {lay['data_size']} x seq "
            f"{lay['seq_size']})")


def _check_layout(path: str, saved, mine) -> None:
    if any(saved.get(k) != mine[k] for k in _LAYOUT_KEYS):
        raise ValueError(
            f"checkpoint {path} was written by {_describe(saved)}; this "
            f"engine is {_describe(mine)}.  Loading into another world "
            "size, engine or shard layout is elastic resume (JAX "
            "resilience/elastic.py), which is not ported yet (ROADMAP.md, "
            "with resilience/): resume with the engine and world that "
            "saved it")


def _check_leaves(what: str, got: Dict, want: Dict) -> List[str]:
    bad = []
    if set(got) != set(want):
        bad.append(f"{what}: names {sorted(set(got) ^ set(want))} differ")
    for n in sorted(set(got) & set(want)):
        g, w = got[n], want[n]
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            bad.append(f"{what} {n}: {tuple(g.shape)} {g.dtype}, expected "
                       f"{tuple(w.shape)} {w.dtype}")
    return bad


def load_checkpoint(directory: str, engine, step: Optional[int] = None, *,
                    retries: int = 3, backoff: float = 0.5):
    """The committed checkpoint `step` (None: the latest) as a TrainState
    in `engine`'s layout on its device, in place of `engine.init`: the
    rank reads only its own file.  Refuses another engine, world size or
    shard layout, and any leaf whose name, shape or dtype differs from
    what the engine would hold.  An engine that keeps an error-feedback
    residual resumes with the saved row, or with zeros from a checkpoint
    without one (JAX :277-290: the feedback loop refills it in a step)."""
    step = _resolve_step(directory, step)
    path = _step_dir(directory, step)
    mine = engine.layout()
    meta = read_meta(directory, step)
    if meta is not None:
        _check_layout(path, meta, mine)
    blob = _read(path, mine["rank"], engine.device, retries, backoff,
                 mine["world"])
    _check_layout(path, blob["layout"], mine)
    params_t, opt_t = engine.state_target()
    opt = blob["opt_state"]
    bad = _check_leaves("param", blob["params"], params_t)
    if set(opt["state"]) != set(opt_t["state"]):
        bad.append("optimizer state: names differ")
    else:
        for n, slots in opt_t["state"].items():
            bad += _check_leaves(f"optimizer slot of {n}", opt["state"][n],
                                 slots)
    res, zero = blob.get("grad_residual"), engine.zero_residual()
    if res is not None and zero is not None and res.shape != zero.shape:
        bad.append(f"grad_residual: {tuple(res.shape)}, expected "
                   f"{tuple(zero.shape)}")
    if bad:
        raise ValueError(f"checkpoint {path} does not fit this engine's "
                         "state: " + "; ".join(bad[:8]))
    return engine.restore(blob["params"], opt, scaler=blob["scaler"],
                          dropout_base=blob["dropout_base"],
                          grad_residual=res)


def load_params(directory: str, step: Optional[int] = None,
                device="cpu") -> Dict[str, torch.Tensor]:
    """The whole params of a committed checkpoint written by any engine
    (None: the latest step), on `device`: rank 0's under stages 0-2;
    under ZeRO-3 every data rank's shards joined by the layout that wrote
    them — block leaves `h.*` per layer, the others flat, data rank d
    owning the d-th run of ceil(n / D) elements (parallel/zero3.py)."""
    step = _resolve_step(directory, step)
    path = _step_dir(directory, step)
    first = torch.load(_rank_file(path, 0), map_location=device,
                       weights_only=True)
    lay = first["layout"]
    if lay["stage"] < 3:
        return first["params"]
    shapes = lay["shapes"]
    # seq rank 0 of each data rank (rank = d * SP + s)
    parts = [first["params"]] + [
        torch.load(_rank_file(path, d * lay["seq_size"]),
                   map_location=device, weights_only=True)["params"]
        for d in range(1, lay["data_size"])]
    out = {}
    for n, shape in shapes.items():
        if n.startswith("h."):
            flat = torch.cat([p[n] for p in parts], dim=1)
        else:
            flat = torch.cat([p[n] for p in parts])
        out[n] = flat.reshape(shape)
    return out
