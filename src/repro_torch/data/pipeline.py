"""Data pipeline: deterministic sharded synthetic token streams + prefetch.

Port of ``repro.data.pipeline``, in numpy as there (the port keeps its own
copy): for the same ``(seed, step)`` a batch is bit-identical to the
reference's. Every host process draws only its own shard of the global
batch, keyed by (seed, step, shard), so the stream is reproducible across
restarts and re-sharding.

The synthetic task is a *learnable* language: a fixed random bigram
transition table (per seed) generates token streams, so the CE loss has
real signal and DistillCycle subnet-vs-full comparisons mean something.
Batches are numpy; ``to_device`` moves one onto the trainer's device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 64
    n_shards: int = 1
    shard: int = 0
    bigram_temperature: float = 1.0


class BigramTask:
    """Fixed random bigram LM over the config vocab (the learnable target)."""

    def __init__(self, vocab: int, seed: int, temperature: float = 1.0):
        rng = np.random.default_rng(seed)
        # sparse-ish logits: each token strongly prefers ~8 successors
        self.vocab = vocab
        self.n_next = min(8, vocab)
        self.succ = rng.integers(0, vocab, size=(vocab, self.n_next))
        self.temperature = temperature

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            choice = rng.integers(0, self.n_next, size=batch)
            nxt = self.succ[toks[:, t], choice]
            # occasional uniform noise keeps entropy > 0
            noise = rng.random(batch) < 0.1
            nxt = np.where(noise, rng.integers(0, self.vocab, size=batch), nxt)
            toks[:, t + 1] = nxt
        return toks


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int,
               task: Optional[BigramTask] = None) -> Dict[str, np.ndarray]:
    """Shard-local batch for ``step`` (numpy).

    The *global* batch is generated from (seed, step) and each shard takes a
    row slice, so re-sharding never changes the global token stream and
    restarts are bit-identical.
    """
    assert dc.global_batch % dc.n_shards == 0
    b = dc.global_batch // dc.n_shards
    rng = np.random.default_rng((dc.seed, step))
    task = task or BigramTask(cfg.vocab_size, dc.seed)
    text_len = dc.seq_len - (cfg.frontend_seq if cfg.frontend == "vision_stub" else 0)
    toks = task.sample(rng, dc.global_batch, text_len)
    lo, hi = dc.shard * b, (dc.shard + 1) * b
    batch = {
        "tokens": toks[lo:hi, :-1].astype(np.int32),
        "targets": toks[lo:hi, 1:].astype(np.int32),
    }
    if cfg.frontend == "vision_stub":
        batch["patches"] = rng.standard_normal(
            (dc.global_batch, cfg.frontend_seq, cfg.frontend_dim))[lo:hi].astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (dc.global_batch, cfg.enc_seq, cfg.frontend_dim))[lo:hi].astype(np.float32)
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (token ids as int64 for indexing)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


class PrefetchIterator:
    """Background-thread prefetch of up to ``depth`` batches."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
                 depth: int = 2):
        self.cfg, self.dc = cfg, dc
        self.task = BigramTask(cfg.vocab_size, dc.seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, self.dc, step, self.task)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
