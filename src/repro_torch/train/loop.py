"""The training loop — ``repro.train.loop``.

Same signature and history records as JAX's ``TrainLoop``: every step
appends {"step", "loss", "time_s"}, the step time measured after the card
has finished the step; a NaN loss raises ``FloatingPointError``.  JAX's
fault tolerance restores the last checkpoint and replays a failed step;
``train/checkpoint.py`` is not ported yet, so ``ckpt_dir``, and a
``save_every`` or ``max_retries`` other than the default, raise
``NotImplementedError``, and a failing step re-raises, as JAX's loop does
when it has no checkpoint directory.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.optim.adamw import AdamWCfg
from repro_torch.optim.schedules import warmup_cosine
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
        # save_every and max_retries act only with checkpoints
        if ckpt_dir is not None or save_every != 50 or max_retries != 3:
            raise NotImplementedError(
                "checkpoint/resume (ckpt_dir, save_every, max_retries) needs "
                "train/checkpoint.py, which is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWCfg()
        self.lr_fn = warmup_cosine(lr, max(1, total_steps // 20), total_steps)
        self.step_fn = make_train_step(cfg, self.opt_cfg, self.lr_fn,
                                       microbatches)
        self.data = SyntheticLMData(cfg, shape, seed, batch_override)
        self.failure_hook = failure_hook
        self.seed = seed

    def init_or_restore(self):
        """A fresh state from ``seed`` (nothing to restore without
        checkpoints) and the step to start from."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return init_train_state(gen, self.cfg, self.opt_cfg,
                                device=self.device), 0

    def run(self, num_steps: int) -> List[Dict[str, float]]:
        state, step = self.init_or_restore()
        history: List[Dict[str, float]] = []
        while step < num_steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(step).items()}
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
            step += 1
        self.final_state = state
        return history
