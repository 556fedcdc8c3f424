"""Deterministic, restart-safe data pipeline (host side, numpy only).

Reference: ``repro/data/pipeline.py``, copied line for line: the batches
are the reference's bit for bit at the same (seed, step).

Swallow principle C1 (independent processors): every host computes its
own shard of every batch from (seed, step) alone — no coordinator, no
state to replay on restart.  Sources:

  * SyntheticLM  — Zipf-distributed token documents packed into fixed-
    length rows with EOS boundaries (default; used by benchmarks & tests).
  * FileTokens   — memory-mapped uint16/uint32 token file, strided reads.

A background-thread prefetcher overlaps host batch assembly with device
compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

EOS = 1


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    path: Optional[str] = None     # set => FileTokens
    dtype: str = "int32"


class SyntheticLM:
    """Zipf token stream packed into (batch, seq) rows, EOS-delimited."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        ranks = np.arange(2, v, dtype=np.float64)  # 0=pad, 1=EOS reserved
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()
        self._vals = np.arange(2, v, dtype=np.int64)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(self._vals, size=(B, S + 1), p=self._probs)
        # plant EOS boundaries ~ geometric(1/mean_doc_len)
        eos_mask = rng.random((B, S + 1)) < (1.0 / cfg.mean_doc_len)
        toks = np.where(eos_mask, EOS, toks)
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        mask = np.ones((B, S), np.float32)
        return {"tokens": tokens, "labels": labels, "mask": mask}


class FileTokens:
    """Strided reads over a flat token file (np.memmap); deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._data = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        self._n = len(self._data) - 1

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        starts = rng.integers(0, self._n - S - 1, size=B)
        rows = np.stack([self._data[s:s + S + 1] for s in starts]).astype(
            np.int64) % cfg.vocab_size
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32),
                "mask": np.ones((B, S), np.float32)}


def make_source(cfg: DataConfig):
    return FileTokens(cfg) if cfg.path else SyntheticLM(cfg)


class Prefetcher:
    """Background-thread prefetch of ``source.batch(step)``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._source.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
