# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""Sampling, the port's entry point: load (or init) a model, generate.

    python -m tiny_deepspeed_tpu_torch.generate [--model gpt2-124m]
        [--ckpt DIR] [--prompt TEXT | --prompt-tokens 1,2,3 |
        --prompt-len N] [--max-new-tokens N] [--temperature T]
        [--top-k K] [--batch B] [--seed S] [--no-cache]      (one line)
    python -m tiny_deepspeed_tpu_torch.generate --device cpu --model tiny

Counterpart of `examples/generate.py`, with every flag of it; the device
flag is `--device cuda|cpu` (default the card), as in `train.py`.
`GPT2Model.generate` is the loop: the prompt's prefill, then one paged
decode step a token over a private KV pool (the serving tier's decode
kernel with its append), through the one sampling core shared with the
serving tier (models/sampling.py).  `--ckpt` loads the whole params of a
`train.py --checkpoint-dir` checkpoint written by any engine
(`utils/checkpoint.load_params`); without it the weights are a seeded
random init.  `--no-cache` runs the full forward a token instead.

Prompts, most specific wins: `--prompt` text through `--tokenizer` (byte
needs no files; gpt2 needs the local HuggingFace cache),
`--prompt-tokens` explicit ids, else `--prompt-len` random tokens
(seeded).  It prints each row (as text with `--prompt`) and the decode
rate: batch x new tokens over the second call's wall (the first builds
and warms the kernels).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .data import tokenizer as tok
from .models import ALL_PRESETS, build_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tiny_deepspeed_tpu_torch.generate",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="tiny", choices=sorted(ALL_PRESETS))
    p.add_argument("--ckpt", default=None, metavar="DIR",
                   help="checkpoint dir from train.py --checkpoint-dir "
                        "(default: a fresh random init)")
    p.add_argument("--prompt", default=None, metavar="TEXT",
                   help="prompt text, tokenized with --tokenizer")
    p.add_argument("--prompt-tokens", default=None, metavar="IDS",
                   help="comma-separated explicit prompt token ids")
    p.add_argument("--tokenizer", default="byte", choices=tok.TOKENIZERS,
                   help="for --prompt, and for rendering outputs as text")
    p.add_argument("--prompt-len", type=int, default=8,
                   help="random-token prompt length when neither --prompt "
                        "nor --prompt-tokens is given")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (the plain PyTorch "
                        "path, for small models)")
    p.add_argument("--no-cache", action="store_true",
                   help="decode with the full forward per token instead of "
                        "the KV cache (greedy outputs match the cached "
                        "path)")
    return p.parse_args(argv)


def _prompt_ids(args, vocab: int):
    """(ids or None, text mode): --prompt or --prompt-tokens."""
    if args.prompt is not None and args.prompt_tokens is not None:
        raise SystemExit("--prompt and --prompt-tokens are exclusive")
    if args.prompt is not None:
        try:
            ids = tok.encode(args.prompt, args.tokenizer)
        except RuntimeError as e:
            raise SystemExit(str(e))
        if len(ids) == 0:
            raise SystemExit("--prompt encoded to zero tokens")
        if tok.min_vocab(args.tokenizer) > vocab:
            raise SystemExit(
                f"--tokenizer {args.tokenizer} needs vocab_size >= "
                f"{tok.min_vocab(args.tokenizer)}; model {args.model} has "
                f"{vocab}")
        return ids.astype(np.int64), True
    if args.prompt_tokens is not None:
        try:
            ids = np.asarray([int(x) for x in args.prompt_tokens.split(",")],
                             np.int64)
        except ValueError:
            raise SystemExit("--prompt-tokens must be a comma-separated "
                             "list of ints")
        if ids.size == 0 or ids.min() < 0 or ids.max() >= vocab:
            raise SystemExit(f"--prompt-tokens ids must be in [0, {vocab})")
        return ids, False
    return None, False


def main(argv=None):
    args = parse_args(argv)
    model = build_model(args.model, device=args.device)
    cfg = model.config
    if args.ckpt:
        from .utils.checkpoint import load_params
        model.load_state_dict(load_params(args.ckpt))
        print(f"loaded params from {args.ckpt}")
    else:
        model.init(torch.Generator(device=model.device).manual_seed(
            args.seed))
        print("fresh random init (pass --ckpt for trained weights)")
    ids, text_mode = _prompt_ids(args, cfg.vocab_size)
    if ids is not None:
        prompt = np.broadcast_to(ids[None], (args.batch, len(ids)))
    else:
        prompt = np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0_len = prompt.shape[1]
    if t0_len + args.max_new_tokens > cfg.block_size:
        raise SystemExit(f"prompt {t0_len} + new {args.max_new_tokens} "
                         f"tokens > model context {cfg.block_size}")
    prompt = torch.as_tensor(np.ascontiguousarray(prompt),
                             device=model.device)

    def gen():
        # a fresh generator a call: both calls draw the same tokens
        g = torch.Generator(device=model.device).manual_seed(args.seed + 1)
        return model.generate(prompt, args.max_new_tokens,
                              temperature=args.temperature,
                              top_k=args.top_k, generator=g,
                              use_cache=not args.no_cache)

    gen()  # the first call builds and warms the kernels
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = gen().cpu()
    dt = time.perf_counter() - t
    for row in out.tolist():
        if text_mode:
            print(f"{args.prompt!r} -> "
                  f"{tok.decode(row[t0_len:], args.tokenizer)!r}")
        else:
            print(f"prompt={row[:t0_len]} -> generated={row[t0_len:]}")
    n = args.batch * args.max_new_tokens
    print(f"decode ({'full forward' if args.no_cache else 'KV cache'}): "
          f"{n / dt:.0f} tokens/s")
    return out


if __name__ == "__main__":
    main()
