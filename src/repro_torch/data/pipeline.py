"""Deterministic synthetic data pipeline — ``repro.data.pipeline``.

``batch_at(step)`` is a pure function of (seed, step) and draws the same
``np.random.RandomState`` stream as the JAX package, so the two give
identical batches: for the audio frontend ``feats`` (B, S, d/2) and
``labels % vocab``, no tokens; for the vision frontend ``img_feats`` (B,
n_img, d/2) after the tokens.  ``iter_from`` places batches on a torch device, with a
bounded background prefetcher building the next host batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg, ShapeCfg


class SyntheticLMData:
    """Markov-ish synthetic tokens (not uniform noise, so loss can fall)."""

    def __init__(self, cfg: ModelCfg, shape: ShapeCfg, seed: int = 0,
                 batch_override: Optional[int] = None):
        self.cfg = cfg
        self.seq = shape.seq_len
        self.batch = batch_override or shape.global_batch
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        B, S, V = self.batch, self.seq, self.cfg.vocab_size
        # low-entropy stream: next token = (token + drift) mod V with noise
        start = rng.randint(0, V, size=(B, 1))
        drift = rng.randint(1, 7, size=(B, 1))
        idx = np.arange(S + 1)[None, :]
        toks = (start + drift * idx) % V
        noise = rng.rand(B, S + 1) < 0.05
        toks = np.where(noise, rng.randint(0, V, size=(B, S + 1)), toks)
        batch = {"tokens": toks[:, :S].astype(np.int32),
                 "labels": toks[:, 1 : S + 1].astype(np.int32)}
        if self.cfg.frontend == "audio":
            batch = {"feats": rng.randn(B, S, self.cfg.d_model // 2)
                     .astype(np.float32),
                     "labels": batch["labels"] % self.cfg.vocab_size}
        elif self.cfg.frontend == "vision":
            batch["img_feats"] = rng.randn(
                B, self.cfg.n_img_tokens, self.cfg.d_model // 2).astype(np.float32)
        return batch

    def iter_from(self, step: int, device=None, prefetch: int = 2
                  ) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches from ``step`` on, as tensors on ``device`` (CPU if None),
        built ``prefetch`` ahead by a background thread that stops when the
        iterator is closed."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            s = step
            while not stop.is_set():
                batch = self.batch_at(s)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                host = q.get()
                yield {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        finally:
            stop.set()
            t.join(timeout=5.0)


def make_data(cfg: ModelCfg, shape: ShapeCfg, seed: int = 0,
              batch_override: Optional[int] = None) -> SyntheticLMData:
    return SyntheticLMData(cfg, shape, seed, batch_override)
