"""End-to-end driver: train a ~100M-param qwen2-family model for a few
hundred steps on synthetic data with checkpointing + resume.

  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]
      [--d-model 512] [--device cpu]

(At the default reduced width this finishes in minutes on one card; a run
killed part-way resumes from the latest checkpoint under ``--ckpt-dir``.)
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import param_count
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.util import dense_lm
from repro_torch.train.loop import TrainLoop


def build_cfg(d_model: int, n_layers: int):
    return dense_lm("qwen2-100m", n_layers=n_layers, d_model=d_model,
                    n_heads=8, n_kv=2, head_dim=d_model // 8, d_ff=4 * d_model,
                    vocab=32768, qkv_bias=True, rope_theta=1e4, tie=True,
                    max_seq_len=2048)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="runs/train_100m")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = build_cfg(args.d_model, args.n_layers)
    print(f"{cfg.name}: {param_count(cfg)/1e6:.1f}M params")
    shape = ShapeCfg("train", args.seq_len, args.batch, "train")
    loop = TrainLoop(cfg, shape, lr=1e-3, total_steps=args.steps,
                     ckpt_dir=args.ckpt_dir, save_every=50,
                     device=resolve_device(args.device))
    hist = loop.run(args.steps)
    k = max(1, len(hist) // 10)
    for i in range(0, len(hist), k):
        print(f"step {hist[i]['step']:4d}  loss {hist[i]['loss']:.4f}  "
              f"{hist[i]['time_s']*1e3:.0f} ms/step")
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} (from {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()
