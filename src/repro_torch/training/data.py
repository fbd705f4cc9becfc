"""Deterministic synthetic data pipeline with prefetch + restart cursor.

Production shape: sharded sequential reader -> tokenize -> pack -> global
batch, with a restore-able cursor (step index) so checkpoint/restart
resumes the exact stream position.  Here the token source is a seeded
generator (no datasets ship with the container), but the pipeline
machinery — per-host sharding, prefetch thread, cursor restore — is real.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 prefetch: int = 2, start_step: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = False
        self._seek = None
        self._expect = start_step
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _batch_at(self, step: int) -> dict:
        """Pure function of (seed, host, step) -> restart-deterministic."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.host_id) * 1_000_003 + step)
        toks = rng.integers(0, self.cfg.vocab_size,
                            (self.batch, self.seq), dtype=np.int32)
        # next-token LM objective: labels = tokens shifted left
        labels = np.concatenate(
            [toks[:, 1:], np.full((self.batch, 1), -100, np.int32)], axis=1)
        out = {"tokens": toks, "labels": labels}
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_seq, self.cfg.d_model)
            ).astype(np.float32)
        if self.cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_seq, self.cfg.d_model)
            ).astype(np.float32)
        return out

    def _produce(self):
        step = self.step
        while not self._stop:
            if self._seek is not None:
                step, self._seek = self._seek, None
            b = self._batch_at(step)
            while not self._stop and self._seek is None:
                try:
                    self._q.put((step, b), timeout=0.1)
                    step += 1
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------------
    def __next__(self) -> dict:
        # discard prefetched batches that predate a seek (restart restore)
        while True:
            step, b = self._q.get()
            if step == self._expect:
                break
        self._expect = step + 1
        self.step = step + 1
        return b

    def __iter__(self) -> Iterator[dict]:
        return self

    def cursor(self) -> int:
        return self.step

    def seek(self, step: int):
        """Reposition the stream (checkpoint-restore path)."""
        self._seek = step
        self._expect = step
        self.step = step

    def close(self):
        self._stop = True
