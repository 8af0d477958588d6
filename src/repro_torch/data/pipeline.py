"""Deterministic, restart-safe token data pipeline (a copy of
``repro.data.pipeline``; numpy only).

Two sources:
  * SyntheticLM — procedurally generated token streams (Zipfian unigrams
    with a repeated-motif structure so models can actually learn), fully
    determined by (seed, step): any host can reproduce any batch, which is
    what makes checkpoint-restart and elastic rescaling exact.
  * FileShards — ``shard_*.npy`` token shards on disk (1-D integer
    arrays), sharded per host, with a resumable cursor.

Batches are numpy int32 arrays, equal to the reference's bit for bit;
the trainer (``launch/train.py``) moves them to the device.  Per-host
sharding: each host materializes only its slice of the global batch
(``host_index`` / ``host_count``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | file
    path: Optional[str] = None
    motif_len: int = 16                # synthetic structure
    motif_count: int = 64


class SyntheticLM:
    """Batch b at step s is a pure function of (seed, s, b) — stateless."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # Zipfian unigram table + a bank of motifs the stream repeats.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.motifs = root.integers(
            0, cfg.vocab_size, size=(cfg.motif_count, cfg.motif_len),
            dtype=np.int64)

    def batch(self, step: int, host_index: int = 0,
              host_count: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // host_count
        rng = np.random.default_rng(
            (cfg.seed, step, host_index))
        length = cfg.seq_len + 1
        rows = np.empty((per_host, length), dtype=np.int64)
        for r in range(per_host):
            stream = rng.choice(cfg.vocab_size, size=length,
                                p=self.unigram)
            # inject motifs: predictable structure for the model to learn
            n_inj = length // (cfg.motif_len * 2)
            starts = rng.integers(0, max(1, length - cfg.motif_len),
                                  size=n_inj)
            for st in starts:
                m = self.motifs[rng.integers(0, cfg.motif_count)]
                stream[st:st + cfg.motif_len] = m[:length - st][:cfg.motif_len]
            rows[r] = stream
        return {"tokens": rows[:, :-1].astype(np.int32),
                "targets": rows[:, 1:].astype(np.int32)}


class FileShards:
    """Token shards: <path>/shard_*.npy (1-D int arrays), resumable."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.files = sorted(
            os.path.join(cfg.path, f) for f in os.listdir(cfg.path)
            if f.startswith("shard_") and f.endswith(".npy"))
        if not self.files:
            raise FileNotFoundError(f"no shard_*.npy under {cfg.path}")

    def batch(self, step: int, host_index: int = 0,
              host_count: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // host_count
        length = cfg.seq_len + 1
        shard = np.load(self.files[(step * host_count + host_index)
                                   % len(self.files)], mmap_mode="r")
        need = per_host * length
        start = (step * need) % max(1, len(shard) - need)
        flat = np.asarray(shard[start:start + need], dtype=np.int64)
        if len(flat) < need:
            flat = np.pad(flat, (0, need - len(flat)))
        rows = flat.reshape(per_host, length)
        return {"tokens": rows[:, :-1].astype(np.int32),
                "targets": rows[:, 1:].astype(np.int32)}


def make_source(cfg: DataConfig):
    return FileShards(cfg) if cfg.source == "file" else SyntheticLM(cfg)


def iterate(cfg: DataConfig, start_step: int = 0, host_index: int = 0,
            host_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    src = make_source(cfg)
    step = start_step
    while True:
        yield src.batch(step, host_index, host_count)
        step += 1
