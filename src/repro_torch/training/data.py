"""Synthetic token data pipeline.

Deterministic, infinite, shardable: each global step's batch is derived
from (seed, step) so every data-parallel worker can materialize its own
shard without communication — the standard deterministic-data recipe.
Sequences are Zipf-distributed token ids with a simple Markov structure
so the LM loss actually decreases during the example runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((cfg.seed << 32) ^ step)
    b, s = cfg.global_batch, cfg.seq_len
    # Zipf-ish marginal with Markov chain: next ~ (prev * a + noise) % V
    base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
    base = np.clip(base, 1, cfg.vocab_size - 1)
    drift = np.cumsum(base, axis=1, dtype=np.int64)
    tokens = (drift % (cfg.vocab_size - 1)) + 1
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32)}


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
