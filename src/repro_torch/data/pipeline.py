"""Deterministic synthetic data pipeline (the reference's
`src/repro/data/pipeline.py`, NumPy only, so the port's batches are
bitwise the reference's).

Token streams are a pure function of (seed, step, position) via a splitmix-
style integer hash — no host RNG state, so any replica can regenerate any
shard (exactly what checkpoint-restart and elastic resizing need: after a
restore the pipeline resumes from the step counter alone).

A background-thread prefetcher overlaps host batch synthesis with the
card's compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


def _hash64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


def synth_tokens(seed: int, step: int, batch: int, seq: int, vocab: int,
                 start_row: int = 0) -> np.ndarray:
    """(batch, seq) int32 tokens, deterministic in (seed, step, row, col)."""
    rows = (start_row + np.arange(batch, dtype=np.uint64))[:, None]
    cols = np.arange(seq, dtype=np.uint64)[None, :]
    base = (np.uint64(seed) << np.uint64(40)) ^ (np.uint64(step) << np.uint64(20))
    h = _hash64(base ^ (rows << np.uint64(32)) ^ cols)
    return (h % np.uint64(vocab)).astype(np.int32)


class SyntheticLM:
    """Batch source for one arch config."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {
            "tokens": synth_tokens(self.seed, step, self.batch, self.seq,
                                   cfg.vocab_size)}
        if cfg.family == "vlm":
            h = synth_tokens(self.seed + 1, step, self.batch,
                             cfg.n_vision_tokens * cfg.d_model, 65536)
            out["vision_embeds"] = (
                (h.reshape(self.batch, cfg.n_vision_tokens, cfg.d_model)
                 .astype(np.float32) / 32768.0 - 1.0) * 0.02).astype(np.float32)
        if cfg.encdec:
            h = synth_tokens(self.seed + 2, step, self.batch,
                             self.seq * cfg.d_model, 65536)
            out = {
                "frames": ((h.reshape(self.batch, self.seq, cfg.d_model)
                            .astype(np.float32) / 32768.0 - 1.0) * 0.02
                           ).astype(np.float32),
                "tokens": synth_tokens(self.seed, step, self.batch,
                                       cfg.dec_train_len, cfg.vocab_size),
            }
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
