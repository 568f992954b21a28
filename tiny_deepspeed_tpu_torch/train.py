# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Training, the port's entry point: one device, DDP, ZeRO-1/2/3.

    python -m tiny_deepspeed_tpu_torch.train [--model gpt2-124m] [--iters N]
    python -m tiny_deepspeed_tpu_torch.train --device cpu --model tiny
    python -m tiny_deepspeed_tpu_torch.train --model llama-160m
    python -m tiny_deepspeed_tpu_torch.train --model moe-8x124m
        [--moe-dispatch sort]                                 (one line)
    torchrun --standalone --nproc-per-node N -m tiny_deepspeed_tpu_torch.train
        --engine zero2 [--seq-parallel SP] [--device cpu]    (one line)
    torchrun ... -m tiny_deepspeed_tpu_torch.train --engine ddp|zero1|zero2|zero3
        --seq-parallel SP --seq-impl ulysses --dropout 0.1    (one line)
    torchrun ... -m tiny_deepspeed_tpu_torch.train --engine zero3
        --model gpt2-1.5b [--gather-quant fp8]                (one line)
    torchrun ... -m tiny_deepspeed_tpu_torch.train --engine zero2
        --tensor-parallel TP [--seq-parallel SP]              (one line)
    torchrun ... -m tiny_deepspeed_tpu_torch.train --model moe-tiny
        --engine ddp --expert-parallel EP [--tensor-parallel TP]
    torchrun ... -m tiny_deepspeed_tpu_torch.train --engine zero3
        --gather-prefetch 2 [--gather-groups M] [--grad-buckets K]
        [--sched gather_prefetch=2,grad_buckets=4,hpz]        (one line)
    torchrun ... -m tiny_deepspeed_tpu_torch.train --engine zero2
        --grad-comm int8 [--grad-comm-groups M] [--grad-buckets K]
        [--sched grad_comm=auto,grad_buckets=auto]            (one line)
    python -m tiny_deepspeed_tpu_torch.train --telemetry [layers]
        --metrics run.jsonl [--flight-steps N] [--telemetry-trace DIR]
    python -m tiny_deepspeed_tpu_torch.train --model gpt2-1.5b
        --offload-opt-state [--offload-prefetch W]            (one line)
    python -m tiny_deepspeed_tpu_torch.train --autotune [CACHE.json]

Counterpart of `examples/{single_device,ddp,zero1,zero2,zero3}/train.py`
with the harness of `examples/common.py` (`parse_args` / `run`): the same
flags, with the same names and defaults, for what the port supports
(`--dropout`, `--fused-xent`, `--seq-parallel`, `--seq-impl`,
`--tensor-parallel`, `--expert-parallel`, `--gather-quant`,
`--moe-dispatch`, the grad-comm codecs' `--grad-comm`,
`--grad-comm-groups`, `--grad-comm-block`,
`--no-grad-comm-error-feedback` and `--hpz-comm`, the collective
schedule's `--grad-buckets`, `--gather-prefetch`, `--gather-groups` and
`--sched` — the spec merges
over those flags and wins, as examples/common.py:451-484 merges it, and
its `health` upgrades the telemetry to layers mode —, the optimizer-state
offload's `--offload-opt-state` / `--offload-prefetch`, and the
telemetry's `--telemetry [on|layers]`, `--flight-steps`,
`--telemetry-trace` and `--metrics` among them), plus `--device`
(default the card) and
`--engine` (default `single`; `examples/zero3/train.py` defaults to
gpt2-1.5b, here `--model` says so).  Seeded init, the JAX package's
token stream (synthetic unless `--data`), `AdamW(lr, weight_decay,
decay_exclude)` with an optional schedule, the engine with optional grad
clipping and loss scaling.  A distributed engine runs one process per
rank under torchrun (NCCL on the card, one card per rank; gloo with
`--device cpu`); without torchrun it is a world of one.  Every rank
draws the same global batch of `--batch-per-device` x world rows and
trains on its block.  Rank 0 prints the engine's description, `model=...
params=...M global_batch=B T=T`, `iter N loss X` per step, optional
`iter N val_loss X`, and `done: N iters in Xs (Y tokens/s)`.

Checkpoints (`--checkpoint-every N --checkpoint-dir DIR`, legacy
`--save-every` / `--save-dir`) commit the TrainState every N iters
through `utils/checkpoint.py`, synchronously (`--checkpoint-sync` is the
port's only mode).  `--resume` restores the latest committed step in
place of init and seeks the data stream to its sample offset (the
indexed stream when the global batch changed), so the run continues the
uninterrupted one's losses; the lr schedule continues from the restored
optimizer step.  JAX's async writer, SIGTERM drain and telemetry-driven
checkpoints are not ported (ROADMAP.md).  `--pipeline-parallel` is
accepted and handed to the engine, which refuses it by name (pipeline
parallelism is the next slice of the port).

Autotuning (`--autotune [CACHE.json]`, examples/common.py:274-280,
:597-630): a `RuntimeAutoTuner` (autotuner/) is installed — loaded from
CACHE.json when the file exists — one probe step on a synthetic batch
(a generator seeded 7) records the dispatch sites' requests,
`engine.retune()` times them (rank 0 on a multi-rank run, its winners
broadcast) and rank 0 prints `autotuned N site(s)` and saves the cache;
the probe state is dropped before the run's own init or resume.  A
candidate that fails while timed ends the run with an error and saves
nothing (a hand kernel's failure on the card is raised at once).  There
is no fp8 flag, as JAX's trainer has none: `ops.matmul_fp8.
set_fp8_matmul` is the API.

Telemetry (`--telemetry`, examples/common.py:453-477, :671-720): rank 0
runs each step inside `Telemetry.step` — the data wait as `data_s`, the
health vector's sync closing the clock — prints the health's loss, and
with `--metrics` logs a step record per iteration (loss, step_s,
tokens_per_s and `Telemetry.step_record`), flushes the flight recorder
at that cadence when an anomaly armed it, and after the loop a
`straggler` record (the ranks' host data wait) and the registry's
`telemetry_summary`.  `--metrics` alone logs loss, step_s and
tokens_per_s.  The records validate under `telemetry/schema.py`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from .autotuner import RuntimeAutoTuner, set_default_tuner
from .data import TokenLoader
from .models import ALL_PRESETS, build_model
from .optim import AdamW
from .optim import schedule as schedules
from .parallel import (DDP, SingleDevice, Zero1, Zero2, Zero3,
                       init_distributed)
from .parallel.schedule import parse_sched_spec
from .telemetry import Telemetry
from .utils import checkpoint as ckpt
from .utils.profiling import MetricsLogger

ENGINES = {"single": SingleDevice, "ddp": DDP, "zero1": Zero1,
           "zero2": Zero2, "zero3": Zero3}


def _loss_scale(v):
    if v == "dynamic":
        return v
    try:
        return float(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{v!r} is not a number or 'dynamic'") from None


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tiny_deepspeed_tpu_torch.train",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="gpt2-124m",
                   choices=sorted(ALL_PRESETS))
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--batch-per-device", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=None,
                   help="default min(1024, model block_size)")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lr-schedule", default="constant",
                   choices=("constant", "warmup_linear", "warmup_cosine",
                            "inverse_sqrt"),
                   help="learning-rate schedule over --iters with --lr as "
                        "the peak")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--wd-exclude", default=None, metavar="PAT[,PAT]",
                   help="comma-separated name substrings exempt from "
                        "weight decay (e.g. '.b,ln_')")
    p.add_argument("--grad-clip", type=float, default=0.0, metavar="NORM",
                   help="clip gradients to this global L2 norm (0 = off)")
    p.add_argument("--loss-scale", type=_loss_scale, default=None,
                   metavar="S", help="a number (static) or 'dynamic'")
    p.add_argument("--dropout", type=float, default=0.0, metavar="P",
                   help="residual/embedding dropout rate, on any "
                        "engine (each rank draws its block of the global "
                        "batch's masks)")
    p.add_argument("--fused-xent", choices=("chunked", "pallas"),
                   default=None,
                   help="fused lm_head+cross-entropy head: 'chunked' "
                        "(plain PyTorch over (B,chunk,V) slabs) or 'pallas' "
                        "(the fused CUDA kernels; logit tiles never leave "
                        "the SM).  Default: full-logits head")
    p.add_argument("--gather-quant", choices=("fp8",), default=None,
                   help="ZeRO++-style quantized weight gather: block "
                        "weights stack as float8_e4m3 codes + per-channel "
                        "scales, so ZeRO-3's per-layer gathers move 1-byte "
                        "codes (lossy; also valid under the other engines)")
    p.add_argument("--moe-dispatch", choices=("einsum", "sort"),
                   default=None,
                   help="MoE families only: token dispatch mechanism "
                        "(MoEConfig.moe_dispatch — 'sort' skips the dense "
                        "one-hot dispatch products on one device and under "
                        "pure data parallelism)")
    p.add_argument("--grad-comm", choices=("fp32", "int8", "fp8"),
                   default="fp32",
                   help="gradient-collective precision "
                        "(parallel/comm.py): int8/fp8 quantize every "
                        "gradient release blockwise with an error-feedback "
                        "residual (~4x less gradient wire; pure "
                        "data-parallel meshes)")
    p.add_argument("--grad-comm-groups", type=int, default=None,
                   metavar="M",
                   help="with --grad-comm int8/fp8: the 2-hop schedule — "
                        "the codes within M consecutive ranks, bf16 "
                        "partial sums across the groups (M a proper "
                        "divisor of the data size)")
    p.add_argument("--grad-comm-block", type=int, default=256, metavar="N",
                   help="elements per absmax scale of the grad codec")
    p.add_argument("--no-grad-comm-error-feedback", action="store_true",
                   help="drop the codec's error-feedback residual")
    p.add_argument("--hpz-comm", choices=("fp32", "int8", "fp8"),
                   default="fp32",
                   help="with hpZ: the once-a-step replica rebuild as "
                        "blockwise codes + scales (qwZ)")
    p.add_argument("--grad-buckets", type=int, default=1, metavar="K",
                   help="bucketed gradient release: K layer buckets (+ the "
                        "non-block tail), each bucket's collective issued "
                        "from inside the backward (K divides n_layer; 1 = "
                        "after the backward)")
    p.add_argument("--gather-prefetch", type=int, default=0, metavar="K",
                   help="ZeRO-3 layer-ahead weight-gather prefetch: layer "
                        "k+K-1's gather in flight while layer k computes, "
                        "at most K layers' gathered weights, forward and "
                        "recompute (0/1 = on demand; zero3 only)")
    p.add_argument("--gather-groups", type=int, default=None, metavar="M",
                   help="with --gather-prefetch >= 2: the 2-hop gather — "
                        "resting precision within M consecutive ranks, "
                        "the compute dtype across the groups")
    p.add_argument("--sched", default=None, metavar="SPEC",
                   help="the collective schedule as one spec, e.g. "
                        "'gather_prefetch=2,grad_buckets=4,grad_comm=int8,"
                        "hpz' (parallel/schedule.parse_sched_spec): also "
                        "'grad_comm_tail=int8' (ZeRO-3's non-block tail "
                        "through the codec), 'hpz_comm=fp8' and "
                        "'grad_comm=auto' / 'grad_buckets=auto' / "
                        "'gather_groups=auto' (sized from the hosts' "
                        "granule map, schedule.auto_comm_plan); merges "
                        "over the flags above and wins")
    p.add_argument("--offload-opt-state", action="store_true",
                   help="ZeRO-Offload-style placement: optimizer moments "
                        "rest in host memory (pinned on the card) and stream "
                        "through the device leaf by leaf for the update")
    p.add_argument("--offload-prefetch", type=int, default=2, metavar="W",
                   help="with --offload-opt-state: leaves of moments in "
                        "flight (>= 1; 1 = serial streaming; default 2)")
    p.add_argument("--metrics", default=None, metavar="FILE.jsonl",
                   help="append per-iter structured metrics (loss, step "
                        "seconds, tokens/s) as JSONL "
                        "(utils/profiling.MetricsLogger)")
    p.add_argument("--telemetry", nargs="?", const="on", default=None,
                   choices=("on", "layers"),
                   help="run telemetry (telemetry/): the health vector "
                        "computed in the step (grad / update / param norms, "
                        "non-finite count), the step-time breakdown, memory "
                        "watermarks, a flight recorder flushed on anomalies "
                        "and straggler gauges; 'layers' adds per-layer "
                        "health (GPT-2 / Llama).  Pairs with --metrics")
    p.add_argument("--telemetry-trace", default=None, metavar="DIR",
                   help="with --telemetry: one torch.profiler trace of the "
                        "step after the first step slower than 2.5x the "
                        "rolling median, into DIR")
    p.add_argument("--flight-steps", type=int, default=64, metavar="N",
                   help="with --telemetry: flight-recorder ring size — the "
                        "last N steps' health flushed as one JSONL 'flight' "
                        "record when the anomaly detector fires (0 "
                        "disables)")
    p.add_argument("--autotune", nargs="?", const="", default=None,
                   metavar="CACHE.json",
                   help="runtime-autotune the dispatch sites' candidates "
                        "(linear layouts and fp8, LayerNorm kernel vs "
                        "plain, the chunked head's chunk, AdamW(fused="
                        "'auto') kernel vs plain): one probe step records "
                        "requests, they are timed on the device, and the "
                        "sites take the winners.  With a path, winners "
                        "persist across runs (ahead-of-time cache)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default=None, metavar="TOKENS.bin",
                   help="uint16 token corpus; default synthetic tokens")
    p.add_argument("--eval-every", type=int, default=0, metavar="N")
    p.add_argument("--eval-batches", type=int, default=8, metavar="K")
    p.add_argument("--val-data", default=None, metavar="VAL.bin")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (the plain PyTorch "
                        "path, for small models)")
    p.add_argument("--engine", default="single", choices=sorted(ENGINES),
                   help="single device, or DDP / ZeRO-1 / ZeRO-2 / ZeRO-3 "
                        "over the torchrun world")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="TP",
                   help="Megatron-style intra-layer sharding over a 'model' "
                        "mesh axis")
    p.add_argument("--seq-parallel", type=int, default=1, metavar="SP",
                   help="sequence/context parallelism over a 'seq' group "
                        "(ring attention or Ulysses); divides the world "
                        "size")
    p.add_argument("--seq-impl", default="ring", choices=("ring", "ulysses"),
                   help="sequence-parallel attention: 'ring' (K/V chunks "
                        "rotate) or 'ulysses' (all-to-all head/sequence "
                        "reshard; n_head must divide by SP).  Inert at "
                        "--seq-parallel 1, as in JAX")
    p.add_argument("--expert-parallel", type=int, default=1, metavar="EP",
                   help="MoE expert sharding over an 'expert' mesh axis "
                        "(use with the moe-* presets)")
    p.add_argument("--pipeline-parallel", type=int, default=1, metavar="PP",
                   help="GPipe microbatch pipeline over a 'pipe' mesh axis: "
                        "not ported yet, the engines refuse PP > 1")
    p.add_argument("--save-every", type=int, default=0, metavar="N",
                   help="legacy alias of --checkpoint-every")
    p.add_argument("--save-dir", default="checkpoints", metavar="DIR",
                   help="legacy alias of --checkpoint-dir")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="commit a checkpoint of the TrainState every N "
                        "iters into --checkpoint-dir, atomically (tmp dir "
                        "+ rename + COMMITTED marker; each rank writes what "
                        "it holds; utils/checkpoint.py)")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="checkpoint directory (default: --save-dir, i.e. "
                        "'checkpoints')")
    p.add_argument("--checkpoint-sync", action="store_true",
                   help="write checkpoints synchronously: the port's only "
                        "mode (the async writer is not ported), accepted "
                        "for the JAX scripts' command lines")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest COMMITTED checkpoint in "
                        "--checkpoint-dir: the state restored in the "
                        "engine's layout and the data stream sought to the "
                        "saved sample offset, so the losses continue the "
                        "uninterrupted run's.  The same engine and world "
                        "size only (elastic resume is not ported)")
    args = p.parse_args(argv)
    if args.seq_len is None:
        args.seq_len = min(1024, ALL_PRESETS[args.model].block_size)
    return args


def _lr(args):
    """--lr / --lr-schedule / --warmup-steps -> a float or a schedule,
    as examples/common.py builds it."""
    if args.lr_schedule == "constant" and not args.warmup_steps:
        return args.lr
    name, kw = args.lr_schedule, {"warmup_steps": args.warmup_steps}
    if name == "constant":
        name, kw = "warmup_linear", dict(kw, min_lr=args.lr)
    elif name == "inverse_sqrt":
        kw["warmup_steps"] = max(1, args.warmup_steps)
    if name in ("warmup_linear", "warmup_cosine"):
        kw["total_steps"] = args.iters
    return schedules.SCHEDULES[name](args.lr, **kw)


def _model_config(args):
    """The preset with --dropout, --fused-xent, --gather-quant and
    --moe-dispatch applied, as examples/common.py:410-429 does (a knob
    the family lacks exits)."""
    cfg = ALL_PRESETS[args.model]
    if args.moe_dispatch:
        if not hasattr(cfg, "moe_dispatch"):
            raise SystemExit(f"--moe-dispatch: the {type(cfg).__name__} "
                             "family has no moe_dispatch knob")
        cfg = dataclasses.replace(cfg, moe_dispatch=args.moe_dispatch)
    if args.dropout:
        cfg = dataclasses.replace(cfg, dropout=args.dropout)
    if args.fused_xent:
        cfg = dataclasses.replace(cfg, fused_xent=True,
                                  fused_xent_impl=args.fused_xent)
    if args.gather_quant:
        cfg = dataclasses.replace(cfg, gather_quant=args.gather_quant)
    return cfg


def _resume_stream(meta, start_iter: int, b: int, say):
    """(sample offset to seek, indexed) for a run resumed at `start_iter`
    with global batch b (examples/common.py:553-591): the per-batch
    stream continues at the saved offset when the batch is unchanged; a
    changed batch, or an offset it does not divide, continues on the
    per-sample indexed stream at that offset."""
    data = (meta or {}).get("data") or {}
    saved_b = data.get("global_batch")
    seen = data.get("samples_seen")
    if data.get("indexed") or (saved_b is not None and int(saved_b) != b):
        if not data.get("indexed"):
            say(f"resume: global batch changed {int(saved_b)} -> {b}; "
                "continuing on the indexed per-sample stream at offset "
                f"{int(seen)}")
        return int(seen), True
    if seen is None:
        return start_iter * b, False
    if int(seen) % b:
        say(f"resume offset {int(seen)} samples not divisible by global "
            f"batch {b}: using the indexed loader")
        return int(seen), True
    return int(seen), False


def _telemetry(args, sched_kw):
    """The run's Telemetry or None: --telemetry, upgraded to layers mode
    by --sched's `health` (examples/common.py:453-466)."""
    layers = (args.telemetry == "layers"
              or sched_kw.pop("telemetry_layers", False))
    if not (args.telemetry or layers):
        return None
    return Telemetry(trace_dir=args.telemetry_trace, layers=layers,
                     flight_steps=args.flight_steps)


def _autotune(args, engine, b, vocab, say, lead):
    """The --autotune life cycle (examples/common.py:597-630): install a
    tuner (loaded from the cache file when it exists), one probe step on
    a synthetic batch, `retune()`, save on rank 0.  The probe state is
    dropped here, before the caller inits or resumes."""
    tuner = RuntimeAutoTuner(verbose=lead)
    if args.autotune and os.path.exists(args.autotune):
        tuner.load(args.autotune)
    set_default_tuner(tuner)
    probe = torch.randint(0, vocab, (b, args.seq_len),
                          generator=torch.Generator().manual_seed(7))
    state = engine.init(args.seed)
    engine.step(state, (probe, probe))
    del state
    say(f"autotuned {engine.retune()} site(s)")
    if tuner.failures:  # nothing is saved: a failure is no winner to keep
        raise SystemExit(f"autotune: {len(tuner.failures)} candidate(s) "
                         f"failed: {tuner.failures}")
    if args.autotune and lead:
        tuner.save(args.autotune)


def run(args):
    sched_kw = parse_sched_spec(args.sched) if args.sched else {}
    telem = _telemetry(args, sched_kw)
    kw = dict(grad_clip=args.grad_clip or None, loss_scale=args.loss_scale,
              grad_buckets=args.grad_buckets,
              gather_prefetch=args.gather_prefetch,
              gather_groups=args.gather_groups, grad_comm=args.grad_comm,
              grad_comm_groups=args.grad_comm_groups,
              grad_comm_block=args.grad_comm_block,
              grad_comm_error_feedback=not args.no_grad_comm_error_feedback,
              hpz_comm=args.hpz_comm,
              offload_opt_state=args.offload_opt_state,
              offload_prefetch=args.offload_prefetch, telemetry=telem)
    kw.update(sched_kw)
    device = args.device
    splits = {"--seq-parallel": args.seq_parallel,
              "--tensor-parallel": args.tensor_parallel,
              "--expert-parallel": args.expert_parallel,
              "--pipeline-parallel": args.pipeline_parallel}
    if args.engine == "single":
        for flag, n in splits.items():
            if n != 1:
                raise SystemExit(f"{flag} needs a distributed --engine")
    else:
        device = init_distributed(args.device)
        kw.update(seq_parallel=args.seq_parallel, seq_impl=args.seq_impl,
                  tensor_parallel=args.tensor_parallel,
                  expert_parallel=args.expert_parallel,
                  pipeline_parallel=args.pipeline_parallel)
    model = build_model(_model_config(args), device=device)
    opt = AdamW(lr=_lr(args), weight_decay=args.weight_decay,
                decay_exclude=tuple(
                    p for p in (args.wd_exclude or "").split(",") if p))
    engine = ENGINES[args.engine](model, opt, device=device, **kw)
    world = dist.get_world_size() if args.engine != "single" else 1
    lead = args.engine == "single" or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    b = args.batch_per_device * world
    say(engine.describe())
    say(f"model={args.model} params={model.num_params() / 1e6:.1f}M "
        f"global_batch={b} T={args.seq_len}")
    ckpt_dir = args.checkpoint_dir or args.save_dir
    ckpt_every = args.checkpoint_every or args.save_every
    vocab = model.config.vocab_size
    if args.autotune is not None:
        _autotune(args, engine, b, vocab, say, lead)
    start_iter = 0
    resume_step = ckpt.latest_step(ckpt_dir) if args.resume else None
    seek, indexed = 0, False
    if resume_step is not None:
        # restore INSTEAD of init: the engine builds its layout from the
        # checkpoint's tensors, no init drawn
        state = ckpt.load_checkpoint(ckpt_dir, engine, step=resume_step)
        start_iter = resume_step
        say(f"resumed from {ckpt_dir} at iter {resume_step}")
        seek, indexed = _resume_stream(ckpt.read_meta(ckpt_dir, resume_step),
                                       start_iter, b, say)
    else:
        state = engine.init(args.seed)
    loader = TokenLoader(args.data, batch=b, seq=args.seq_len,
                         vocab_size=vocab, seed=args.seed, indexed=indexed)
    if seek:
        loader.seek_samples(seek)
    val_loader = (TokenLoader(args.val_data, batch=b, seq=args.seq_len,
                              vocab_size=vocab, seed=args.seed + 1)
                  if args.eval_every else None)
    metrics = MetricsLogger(args.metrics, stdout=False) if args.metrics \
        else None
    t0 = time.perf_counter()
    data_s = 0.0  # this rank's host data wait: the straggler quantity
    for it in range(start_iter, args.iters):
        it_t0 = time.perf_counter()
        if telem is not None and lead:
            # the health vector's sync closes the step clock: one
            # transfer delivers the loss and the norms
            with telem.step(index=it) as t:
                batch = loader.next()
                t.mark("data")
                data_s += time.perf_counter() - it_t0
                state, loss = engine.step(state, batch)
            health = telem.last_health
            loss = health["loss"] if health is not None else float(loss)
            it_dt = telem.timer.times[-1]
            rec = telem.step_record()
        else:
            batch = loader.next()
            data_s += time.perf_counter() - it_t0
            state, loss = engine.step(state, batch)
            loss = float(loss)  # syncs the step
            it_dt = time.perf_counter() - it_t0
            rec = {}
        say(f"iter {it:3d} loss {loss:.4f}")
        if metrics is not None:
            metrics.log(it, loss=loss, step_s=it_dt,
                        tokens_per_s=b * args.seq_len / max(it_dt, 1e-9),
                        **rec)
            if telem is not None and lead:
                reason = telem.maybe_flush_flight(metrics)
                if reason is not None:
                    say(f"iter {it:3d} flight record flushed (reason: "
                        f"{reason})")
        if args.eval_every and (it + 1) % args.eval_every == 0:
            vals = [float(engine.eval_loss(state, val_loader.next()))
                    for _ in range(args.eval_batches)]
            say(f"iter {it:3d} val_loss {sum(vals) / len(vals):.4f}")
        if ckpt_every and (it + 1) % ckpt_every == 0:
            path = ckpt.save_checkpoint(ckpt_dir, state, it + 1, meta={
                "model": args.model,
                "data": {"samples_seen": loader.samples_seen,
                         "global_batch": b, "seed": args.seed,
                         "indexed": loader.indexed}})
            say(f"saved checkpoint at iter {it + 1} ({path})")
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = args.iters - start_iter
    if telem is not None and metrics is not None:
        if n:  # every rank gathers (a collective); rank 0 writes
            metrics.log_meta(kind="straggler", **telem.sample_stragglers(
                step_s=data_s / n, quantity="host_prep_s"))
        telem.flush(metrics)
    if metrics is not None:
        metrics.close()
    toks = n * b * args.seq_len
    say(f"done: {n} iters in {dt:.1f}s ({toks / max(dt, 1e-9):.0f} "
        "tokens/s)")
    if telem is not None and lead and telem.timer.times:
        tm = telem.timer
        say(f"step time p50 {tm.p50_s * 1e3:.1f}ms p95 "
            f"{tm.p95_s * 1e3:.1f}ms p99 {tm.p99_s * 1e3:.1f}ms max "
            f"{tm.max_s * 1e3:.1f}ms")
    return state


def main(argv=None):
    args = parse_args(argv)
    try:
        return run(args)
    finally:
        if args.engine != "single" and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
