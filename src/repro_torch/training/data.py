"""Data pipeline: deterministic synthetic corpus + file-backed token streams.

The synthetic stream produces structured (learnable) sequences so the
train-loop tests can assert loss *decreases*; the file loader memory-maps
token shards for real runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    path: Optional[str] = None      # token shard (.npy) for file-backed mode


def synthetic_batches(cfg: DataConfig, model_cfg: Optional[ModelConfig] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish synthetic stream: next token = (a*tok + b) % V with noise,
    so a causal LM can reduce loss quickly."""
    rng = np.random.default_rng(cfg.seed)
    a = 31, 17
    K = model_cfg.n_codebooks if model_cfg and model_cfg.n_codebooks else 0
    while True:
        if K:
            toks = np.zeros((cfg.batch_size, K, cfg.seq_len + 1), np.int32)
            toks[:, :, 0] = rng.integers(0, cfg.vocab_size,
                                         (cfg.batch_size, K))
            for t in range(cfg.seq_len):
                nxt = (toks[:, :, t] * a[0] + a[1]) % cfg.vocab_size
                noise = rng.random((cfg.batch_size, K)) < 0.05
                nxt = np.where(noise, rng.integers(0, cfg.vocab_size,
                                                   (cfg.batch_size, K)), nxt)
                toks[:, :, t + 1] = nxt
            yield {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
        else:
            toks = np.zeros((cfg.batch_size, cfg.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, cfg.vocab_size, cfg.batch_size)
            for t in range(cfg.seq_len):
                nxt = (toks[:, t] * a[0] + a[1]) % cfg.vocab_size
                noise = rng.random(cfg.batch_size) < 0.05
                nxt = np.where(noise,
                               rng.integers(0, cfg.vocab_size, cfg.batch_size),
                               nxt)
                toks[:, t + 1] = nxt
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def file_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Memory-mapped token shard -> fixed-length LM batches."""
    data = np.load(cfg.path, mmap_mode="r")
    n = (len(data) - 1) // cfg.seq_len
    rng = np.random.default_rng(cfg.seed)
    while True:
        idx = rng.integers(0, n, cfg.batch_size)
        toks = np.stack([data[i * cfg.seq_len:(i + 1) * cfg.seq_len + 1]
                         for i in idx]).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batches(cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
    if cfg.path:
        return file_batches(cfg)
    return synthetic_batches(cfg, model_cfg)
