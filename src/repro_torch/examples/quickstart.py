"""Quickstart: build a small model, train a few steps, decode a sample.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.models import model as M
from repro_torch.train.loop import TrainLoop

ARCH = "qwen2-1.5b"  # any of the registry's decoder archs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(ARCH, smoke=True)  # reduced config
    shape = ShapeCfg("quickstart", seq_len=64, global_batch=8, kind="train")

    print(f"training {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}) "
          f"on {device} ...")
    loop = TrainLoop(cfg, shape, lr=3e-3, total_steps=100, device=device)
    history = loop.run(args.steps)
    print(f"loss: {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")

    params = loop.final_state["params"]
    state = M.init_decode_state(params, cfg, 1, 128)
    prompt = torch.arange(8, device=device)[None] % cfg.vocab_size
    state = M.prefill(params, cfg, state, prompt)
    tok = prompt[:, -1:]
    out = []
    for _ in range(12):
        logits, state = M.decode_step(params, cfg, state, tok)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out.append(int(tok[0, 0]))
    print("greedy continuation:", out)
    return history, out


if __name__ == "__main__":
    main()
