# Copyright 2026 tiny-deepspeed-tpu authors
# SPDX-License-Identifier: Apache-2.0

"""TokenLoader: (B, T) next-token batches, the JAX package's stream.

The port's own copy of the NumPy path of `tiny_deepspeed_tpu/data/
loader.py::TokenLoader` (:80-249): batch for batch the same tokens as the
JAX `TokenLoader(..., force_numpy=True)`.  The native C++ prefetching
pipeline is not ported yet.

Two modes, both deterministic per seed:
  * corpus mode: `TokenLoader("tokens.bin", ...)` — random crops of a
    memory-mapped uint16 (or `.u32`) token file, targets pre-shifted;
  * synthetic mode: `TokenLoader(None, vocab_size=...)` — uniform random
    tokens (the reference demo workload).

Batch i of the per-batch stream is drawn from `default_rng((seed, i))`;
`indexed=True` draws sample g of the global stream from
`default_rng((seed, _IDX_TAG, g))`, so any sample offset can be sought.

Under the distributed engines every process draws the same GLOBAL batch
and `rank_block` cuts its own block out of it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# rng-key tag separating the indexed per-sample stream from the per-batch
# stream (the JAX package's constant)
_IDX_TAG = 0x1D5A


class TokenLoader:
    """Iterator of (x, y) int32 arrays of shape (batch, seq)."""

    def __init__(self, path: Optional[str], batch: int, seq: int,
                 vocab_size: int = 50304, seed: int = 0,
                 indexed: bool = False):
        self.batch, self.seq, self.vocab = batch, seq, vocab_size
        self.seed = seed
        self.indexed = bool(indexed)
        self.samples_seen = 0
        self._rng_counter = 0
        if path:
            width = np.uint32 if path.endswith(".u32") else np.uint16
            self._tokens = np.memmap(path, dtype=width, mode="r")
            if self._tokens.size < seq + 2:
                raise FileNotFoundError("corpus smaller than one sequence")
        else:
            self._tokens = None

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        out = self._indexed_next() if self.indexed else self._batch_next()
        self.samples_seen += self.batch
        return out

    def _batch_next(self):
        rng = np.random.default_rng((self.seed, self._rng_counter))
        self._rng_counter += 1
        if self._tokens is not None:
            usable = self._tokens.size - self.seq - 1
            return self._crops(rng.integers(0, usable, size=self.batch))
        seqs = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                            dtype=np.int32)
        return seqs[:, :-1], seqs[:, 1:]

    def _indexed_next(self):
        """Samples [samples_seen, samples_seen + batch) of the global
        per-sample stream."""
        base = self.samples_seen
        if self._tokens is not None:
            usable = self._tokens.size - self.seq - 1
            starts = [int(np.random.default_rng(
                (self.seed, _IDX_TAG, base + j)).integers(0, usable))
                for j in range(self.batch)]
            return self._crops(starts)
        seqs = np.stack([
            np.random.default_rng((self.seed, _IDX_TAG, base + j)).integers(
                0, self.vocab, size=self.seq + 1, dtype=np.int32)
            for j in range(self.batch)])
        return seqs[:, :-1], seqs[:, 1:]

    def _crops(self, starts):
        x = np.stack([self._tokens[s:s + self.seq] for s in starts])
        y = np.stack([self._tokens[s + 1:s + self.seq + 1] for s in starts])
        return x.astype(np.int32), y.astype(np.int32)

    def seek_samples(self, n: int) -> None:
        """Fast-forward the stream to global sample offset `n`: any offset
        in indexed mode, a batch-aligned one otherwise."""
        n = int(n)
        if n < self.samples_seen:
            raise ValueError(
                f"cannot seek backwards (at sample {self.samples_seen}, "
                f"asked for {n}); build a fresh loader")
        if self.indexed:
            self.samples_seen = n
            return
        if (n - self.samples_seen) % self.batch:
            raise ValueError(
                f"seek to sample {n} is not batch-aligned for "
                f"batch={self.batch} (at {self.samples_seen}); use "
                f"TokenLoader(indexed=True) for arbitrary offsets")
        self._rng_counter += (n - self.samples_seen) // self.batch
        self.samples_seen = n

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


def rank_block(batch, pctx):
    """The block of a global (..., B, T) batch that rank (d, s) of the
    (data, seq) layout trains on: rows [d*B/D, (d+1)*B/D) and columns
    [s*Tl, (s+1)*Tl), Tl = T/S (the JAX engines' batch spec P("data",
    "seq")).  `pctx` gives data_rank, data_size, seq_rank and seq_size;
    B must divide by D and T by S.  Works on numpy arrays and tensors."""
    b, t = batch.shape[-2], batch.shape[-1]
    dp, sp = pctx.data_size, pctx.seq_size
    if b % dp or t % sp:
        raise ValueError(f"global batch (B={b}, T={t}) does not split over "
                         f"data={dp} x seq={sp}")
    bl, tl = b // dp, t // sp
    d, s = pctx.data_rank, pctx.seq_rank
    return batch[..., d * bl:(d + 1) * bl, s * tl:(s + 1) * tl]
