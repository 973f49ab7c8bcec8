"""Deterministic synthetic LM token stream.

The port of ``repro.data.tokens`` (numpy only, so the stream is the same
bits for the same (seed, step, shard)).  Token ``t + 1`` is a splitmix64
hash of ``t // 2`` with occasional noise tokens, which gives learnable
bigram structure: a model can bring the loss well below ``log |V|``.

Batches are a pure function of (seed, step, shard): a resumed job
regenerates exactly the stream it needs from the step counter alone.
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    """splitmix64-style integer hash (vectorised, uint64)."""
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15 + salt)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def synthetic_tokens(
    batch: int, seq_len: int, vocab: int, *, seed: int, step: int, shard: int = 0
) -> np.ndarray:
    """(batch, seq_len + 1) int32 tokens; deterministic in (seed, step, shard)."""
    n = batch * (seq_len + 1)
    base = (
        np.uint64(seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(7_777_777)
        + np.uint64(shard) * np.uint64(104_729)
    )
    idx = np.arange(n, dtype=np.uint64) + base
    # bigram structure: token i depends on hash(i // 2), so consecutive pairs
    # correlate
    stream = _mix(idx >> np.uint64(1), 17) % np.uint64(max(vocab - 1, 1))
    noise = _mix(idx, 29) % np.uint64(max(vocab - 1, 1))
    take_noise = (_mix(idx, 43) % np.uint64(5)) == 0
    toks = np.where(take_noise, noise, stream).astype(np.int64) % vocab
    return toks.reshape(batch, seq_len + 1).astype(np.int32)


def token_batches(
    batch: int,
    seq_len: int,
    vocab: int,
    *,
    seed: int = 0,
    start_step: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens, labels), both (B, S) int32, forever.

    ``shard_index / shard_count`` partition the batch dimension, so data
    parallel workers see disjoint rows of one global stream.
    """
    if batch % shard_count:
        raise ValueError(f"global batch {batch} does not divide by {shard_count} shards")
    local = batch // shard_count
    step = start_step
    while True:
        full = synthetic_tokens(batch, seq_len, vocab, seed=seed, step=step, shard=0)
        mine = full[shard_index * local : (shard_index + 1) * local]
        yield mine[:, :-1], mine[:, 1:]
        step += 1
