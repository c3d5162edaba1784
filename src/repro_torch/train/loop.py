"""The training loop: step + checkpoint/resume + failure handling —
``repro.train.loop``.

Same signature and history records as JAX's ``TrainLoop``: every step
appends {"step", "loss", "time_s"}, the step time measured after the card
has finished the step; a NaN loss raises ``FloatingPointError``.  The
fault-tolerance contract is JAX's:
  - with ``ckpt_dir``, a checkpoint every ``save_every`` steps (a host
    snapshot taken before the next step, the file written by a background
    thread, joined before the next save) and one of the final step;
  - a fresh loop resumes from the latest checkpoint, and the data
    pipeline lands on exactly the next unseen batch (``batch_at``);
  - a step failure (the ``failure_hook`` in tests) restores the last
    checkpoint and replays, up to ``max_retries`` failures in a row;
    without ``ckpt_dir`` it re-raises, and ``FloatingPointError`` always
    does.
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.optim.adamw import AdamWCfg
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import init_train_state, make_train_step


class TrainLoop:
    def __init__(self, cfg: ModelCfg, shape: ShapeCfg, *,
                 opt_cfg: Optional[AdamWCfg] = None,
                 lr: float = 3e-4, total_steps: int = 1000,
                 microbatches: int = 1,
                 ckpt_dir: Optional[str] = None, save_every: int = 50,
                 seed: int = 0, batch_override: Optional[int] = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 max_retries: int = 3, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWCfg()
        self.lr_fn = warmup_cosine(lr, max(1, total_steps // 20), total_steps)
        self.step_fn = make_train_step(cfg, self.opt_cfg, self.lr_fn,
                                       microbatches)
        self.data = SyntheticLMData(cfg, shape, seed, batch_override)
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.save_every = save_every
        self.failure_hook = failure_hook
        self.max_retries = max_retries
        self.seed = seed

    def init_or_restore(self):
        """A fresh state from ``seed`` on the loop's device, with the latest
        checkpoint under ``ckpt_dir`` copied into it if there is one, and
        the step to start from."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        state = init_train_state(gen, self.cfg, self.opt_cfg,
                                 device=self.device)
        if self.ckpt_dir is not None:
            latest = ckpt_lib.latest_step(self.ckpt_dir)
            if latest is not None:
                ckpt_lib.restore_checkpoint(self.ckpt_dir, state, step=latest)
                return state, latest
        return state, 0

    def run(self, num_steps: int) -> List[Dict[str, float]]:
        state, step = self.init_or_restore()
        history: List[Dict[str, float]] = []
        retries = 0
        writer = None
        while step < num_steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(step).items()}
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)  # may raise (test injection)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                history.append({"step": step, "loss": loss,
                                "time_s": time.perf_counter() - t0})
                if math.isnan(loss):
                    raise FloatingPointError(f"NaN loss at step {step}")
                retries = 0
                step += 1
            except FloatingPointError:
                raise
            except Exception:  # servelint: ignore[broad-except] — crash-recovery retry, as JAX's loop: any step failure restores from the checkpoint and replays; re-raised once max_retries is exhausted or without a checkpoint directory
                retries += 1
                if retries > self.max_retries or self.ckpt_dir is None:
                    raise
                if writer is not None:
                    writer.join()  # the checkpoint being written is the one to restore
                state, step = self.init_or_restore()  # restore + replay
                continue
            if self.ckpt_dir is not None and step % self.save_every == 0:
                if writer is not None:
                    writer.join()
                writer = ckpt_lib.save_checkpoint(self.ckpt_dir, state, step,
                                                  background=True)
        if writer is not None:
            writer.join()
        if self.ckpt_dir is not None:
            ckpt_lib.save_checkpoint(self.ckpt_dir, state, step)
        self.final_state = state
        return history
