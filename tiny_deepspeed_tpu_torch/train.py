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
    torchrun ... -m tiny_deepspeed_tpu_torch.train --engine zero3
        --model gpt2-1.5b [--gather-quant fp8]                (one line)

Counterpart of `examples/{single_device,ddp,zero1,zero2,zero3}/train.py`
with the harness of `examples/common.py` (`parse_args` / `run`): the same
flags, with the same names and defaults, for what the port supports
(`--dropout`, `--fused-xent`, `--seq-parallel`, `--gather-quant`,
`--moe-dispatch` among them), plus `--device` (default the card) and
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
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from .data import TokenLoader
from .models import ALL_PRESETS, build_model
from .optim import AdamW
from .optim import schedule as schedules
from .parallel import (DDP, SingleDevice, Zero1, Zero2, Zero3,
                       init_distributed)

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
                   help="residual/embedding dropout rate")
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
    p.add_argument("--seq-parallel", type=int, default=1, metavar="SP",
                   help="sequence/context parallelism over a 'seq' group "
                        "(ring attention); divides the world size")
    p.add_argument("--seq-impl", default="ring", choices=("ring", "ulysses"),
                   help="sequence-parallel attention (only the ring is "
                        "ported)")
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


def run(args):
    kw = dict(grad_clip=args.grad_clip or None, loss_scale=args.loss_scale)
    device = args.device
    if args.engine == "single":
        if args.seq_parallel != 1:
            raise SystemExit("--seq-parallel needs a distributed --engine")
    else:
        device = init_distributed(args.device)
        kw.update(seq_parallel=args.seq_parallel, seq_impl=args.seq_impl)
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
    state = engine.init(args.seed)
    vocab = model.config.vocab_size
    loader = TokenLoader(args.data, batch=b, seq=args.seq_len,
                         vocab_size=vocab, seed=args.seed)
    val_loader = (TokenLoader(args.val_data, batch=b, seq=args.seq_len,
                              vocab_size=vocab, seed=args.seed + 1)
                  if args.eval_every else None)
    t0 = time.perf_counter()
    for it in range(args.iters):
        state, loss = engine.step(state, loader.next())
        loss = float(loss)  # syncs the step
        say(f"iter {it:3d} loss {loss:.4f}")
        if args.eval_every and (it + 1) % args.eval_every == 0:
            vals = [float(engine.eval_loss(state, val_loader.next()))
                    for _ in range(args.eval_batches)]
            say(f"iter {it:3d} val_loss {sum(vals) / len(vals):.4f}")
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.iters * b * args.seq_len
    say(f"done: {args.iters} iters in {dt:.1f}s ({toks / dt:.0f} tokens/s)")
    return state


def main(argv=None):
    args = parse_args(argv)
    try:
        run(args)
    finally:
        if args.engine != "single" and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
