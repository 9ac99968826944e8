"""Deterministic synthetic data pipeline.

Real-framework API (shards, epochs, prefetch-ready iterators) over procedurally
generated token streams, so experiments are exactly reproducible offline.  The
stream is a Markov-ish mixture: token t+1 depends on token t through a seeded
permutation plus noise — learnable structure (loss decreases) without any
external dataset.  Each data-parallel shard slices the global batch.

The port's copy of ``repro.data.pipeline``: numpy only, byte for byte the
same batches, kept here so that the port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..models import ModelConfig

__all__ = ["DataConfig", "SyntheticLMDataset", "make_batch_iterator", "synthetic_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    noise: float = 0.1       # P(random token) vs structured continuation
    shard_index: int = 0
    num_shards: int = 1


class SyntheticLMDataset:
    """Infinite deterministic LM stream; batch b of step s is a pure function
    of (seed, s, b) — restarts and shard re-slicing reproduce identical data."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide evenly across shards")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)  # the "grammar"

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.global_batch // cfg.num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.shard_index)
        first = rng.integers(0, cfg.vocab_size, size=(local, 1))
        toks = [first]
        for _ in range(cfg.seq_len - 1):
            nxt = self.perm[toks[-1]]
            noise = rng.integers(0, cfg.vocab_size, size=nxt.shape)
            use_noise = rng.random(nxt.shape) < cfg.noise
            toks.append(np.where(use_noise, noise, nxt))
        tokens = np.concatenate(toks, axis=1).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)  # shift-left
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_iterator(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    return iter(SyntheticLMDataset(cfg))


def synthetic_batch(model_cfg: ModelConfig, batch: int, seq_len: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """One batch with family-appropriate inputs (for smoke tests / examples)."""
    rng = np.random.default_rng(seed)
    if model_cfg.frontend == "audio_stub":
        return {
            "features": rng.standard_normal(
                (batch, seq_len, model_cfg.frontend_dim)).astype(np.float32),
            "labels": rng.integers(0, model_cfg.vocab_size,
                                   (batch, seq_len)).astype(np.int32),
        }
    if model_cfg.frontend == "vision_stub":
        P = model_cfg.n_prefix_embeds
        text = max(seq_len - P, 1)
        return {
            "patch_embeds": rng.standard_normal(
                (batch, P, model_cfg.frontend_dim)).astype(np.float32),
            "tokens": rng.integers(0, model_cfg.vocab_size,
                                   (batch, text)).astype(np.int32),
            "labels": rng.integers(0, model_cfg.vocab_size,
                                   (batch, text)).astype(np.int32),
        }
    data = SyntheticLMDataset(DataConfig(
        global_batch=batch, seq_len=seq_len,
        vocab_size=model_cfg.vocab_size, seed=seed))
    return data.batch_at(0)
