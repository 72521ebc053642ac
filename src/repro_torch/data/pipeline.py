"""Deterministic, resumable, shardable data pipeline — the port's copy of
``repro.data.pipeline`` (numpy only, so ``batch_at(step)`` is bitwise the
JAX package's).

Sources:
  * SyntheticLM — seeded random token streams (CI / smoke / dry-run scale)
  * MMapTokens  — memory-mapped packed uint16/uint32 token files (production
    path: one flat array of tokens, sequence-packed on the fly)

Determinism & fault tolerance: batches are a pure function of (seed, step),
so a restart at step k regenerates exactly the batch stream from k — no
iterator state to checkpoint beyond the step counter already in the train
state.  Per-host sharding slices the global batch by data-parallel rank.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"        # synthetic | mmap
    path: Optional[str] = None       # token file for mmap
    seed: int = 0
    dp_rank: int = 0                 # this host's data-parallel rank
    dp_size: int = 1


class SyntheticLM:
    """Zipf-ish random tokens — shaped like real text token statistics."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, data: DataConfig):
        self.cfg, self.shape, self.data = cfg, shape, data
        _check_split(shape, data)
        self.local_batch = shape.global_batch // data.dp_size

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.data.seed * 1_000_003 + step) * 65_537 + self.data.dp_rank)
        b, s, v = self.local_batch, self.shape.seq_len, self.cfg.vocab_size
        # Zipf over the vocab, clipped
        toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        toks = np.minimum(toks - 1, v - 1).astype(np.int32)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.input_mode == "embeddings":
            emb = rng.standard_normal(
                (b, s, self.cfg.d_model), dtype=np.float32)
            batch["inputs"] = emb
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MMapTokens:
    """Packed flat token file; deterministic strided sequence sampling."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, data: DataConfig,
                 dtype=np.uint16):
        self.cfg, self.shape, self.data = cfg, shape, data
        self.tokens = np.memmap(data.path, dtype=dtype, mode="r")
        self.n_tokens = len(self.tokens)
        _check_split(shape, data)
        self.local_batch = shape.global_batch // data.dp_size
        self.n_seqs = (self.n_tokens - 1) // shape.seq_len

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(self.data.seed * 1_000_003 + step)
        # one global permutation draw per step; slice this host's ranks
        idx = rng.integers(0, self.n_seqs, size=self.shape.global_batch)
        lo = self.data.dp_rank * self.local_batch
        idx = idx[lo: lo + self.local_batch]
        s = self.shape.seq_len
        rows = np.stack([
            np.asarray(self.tokens[i * s: i * s + s + 1]) for i in idx])
        rows = rows.astype(np.int32) % self.cfg.vocab_size
        return {"inputs": rows[:, :-1], "targets": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def _check_split(shape: ShapeConfig, data: DataConfig) -> None:
    if shape.global_batch % data.dp_size:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {data.dp_size} data-parallel ranks")


def make_pipeline(cfg: ModelConfig, shape: ShapeConfig, data: DataConfig):
    if data.source == "mmap":
        return MMapTokens(cfg, shape, data)
    return SyntheticLM(cfg, shape, data)


def write_token_file(path: str, tokens: np.ndarray):
    """Helper for tests/examples: write a packed token file."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tokens.astype(np.uint16).tofile(path)
