"""Training launcher for the PyTorch port: ``--arch <id>`` with the JAX
launcher's flags plus ``--device`` (``cuda`` by default; ``--device cpu``
runs the plain PyTorch versions of the kernels) and ``--use-flash`` (sets
the config's ``use_flash``: attention through the flash-attention kernel).
``--ckpt-dir D`` checkpoints into D (every 50 steps and the last) and
resumes from D's latest checkpoint; ``--int8-opt`` stores the AdamW
moments as int8 with rowwise scales.  Every config of the registry
trains, the audio (hubert-xlarge) and vision (llama-3.2-vision-11b)
frontends on random features from the seed.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge --smoke --device cpu --steps 3 --ckpt-dir D --int8-opt
"""
import argparse

from repro_torch.configs import ARCH_NAMES, SHAPES_BY_NAME, ShapeCfg, get_config
from repro_torch.optim.adamw import AdamWCfg
from repro_torch.train.loop import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--shape", default=None,
                    help="assigned shape name (e.g. train_4k); default: tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--use-flash", action="store_true",
                    help="route attention through the flash-attention kernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.use_flash:
        cfg = cfg.replace(use_flash=True)
    shape = (SHAPES_BY_NAME[args.shape] if args.shape
             else ShapeCfg("tiny", 64, 8, "train"))
    opt = AdamWCfg(state_dtype="int8" if args.int8_opt else "float32")
    loop = TrainLoop(cfg, shape, opt_cfg=opt, lr=args.lr,
                     total_steps=args.steps, microbatches=args.microbatches,
                     ckpt_dir=args.ckpt_dir, device=args.device)
    hist = loop.run(args.steps)
    print(f"{cfg.name}: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"({args.steps} steps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
