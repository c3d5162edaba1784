"""Serving launcher for the PyTorch port: batched requests through the
ragged token-budget engine (``--engine ragged``) or the two-phase engine
(``--engine chunked``: batched prefill chunks, then decode ticks), with the
JAX launcher's flags plus ``--device`` (``cuda`` by default; ``--device
cpu`` runs the plain PyTorch versions of the kernels).  Like the JAX
launcher it serves the smoke config of ``--arch`` from seed-0 random
weights.  ``--scheduler`` picks the admission and packing policy, and
``--interactive-every N`` submits every Nth request at priority 1 (the
class the slo scheduler serves first and never preempts).  ``--engine
reference`` runs the lock-step ``ReferenceEngine`` (greedy, no sampling
flags, no priorities, no stats line), the A/B baseline of the other two.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --engine reference --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --engine chunked --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --engine chunked --flash-decode
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --scheduler slo --interactive-every 3
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config, skip_reason
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.reference import ReferenceEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-1.5b")
    ap.add_argument("--engine", choices=("ragged", "chunked", "reference"),
                    default="ragged")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-pages", type=int, default=None,
                    help="physical page-pool budget (default: full)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--token-budget", type=int, default=128,
                    help="tokens per ragged tick (prefill + decode blend)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with --top-k/--seed")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request sampling seed base")
    ap.add_argument("--flash-decode", action="store_true",
                    help="route attention through the paged CUDA kernels "
                         "(the ragged step's; the chunked engine's decode "
                         "ticks)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the refcounted prefix cache / COW pages")
    ap.add_argument("--kv-dtype", choices=("float32", "bfloat16", "int8"),
                    default=None,
                    help="paged KV pool storage dtype (default: activation "
                         "dtype); int8 quantizes on write with per-entry-"
                         "per-head scales")
    ap.add_argument("--scheduler", choices=("fifo", "prefix-aware", "slo"),
                    default="fifo",
                    help="admission/packing policy")
    ap.add_argument("--interactive-every", type=int, default=0, metavar="N",
                    help="mark every Nth request priority 1 (the "
                         "interactive class the slo scheduler serves first)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    if skip_reason(args.arch, "decode_32k"):
        raise SystemExit(f"{args.arch}: {skip_reason(args.arch, 'decode_32k')}")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = M.init_params(cfg, generator=torch.Generator(device).manual_seed(0),
                           device=device)
    cache_len = max(128, args.prompt_len + args.max_tokens)
    reference = args.engine == "reference"
    if reference:
        engine = ReferenceEngine(params, cfg, batch_size=args.batch_size,
                                 cache_len=cache_len, device=device)
    else:
        engine = ServeEngine(params, cfg, batch_size=args.batch_size,
                             cache_len=cache_len, page_size=args.page_size,
                             max_pages=args.max_pages,
                             prefill_chunk=args.prefill_chunk,
                             token_budget=args.token_budget,
                             ragged=args.engine == "ragged",
                             flash_decode=args.flash_decode,
                             prefix_cache=not args.no_prefix_cache,
                             kv_dtype=args.kv_dtype, scheduler=args.scheduler,
                             device=device)
    rng = np.random.RandomState(0)
    sample_kw = {}
    if not reference and args.temperature > 0:
        sample_kw = dict(temperature=args.temperature, top_k=args.top_k)

    def _priority(i):
        if reference or not args.interactive_every:
            return {}
        return {"priority": int((i + 1) % args.interactive_every == 0)}

    uids = [engine.submit(rng.randint(0, cfg.vocab_size, args.prompt_len),
                          max_tokens=args.max_tokens,
                          **(dict(sample_kw, seed=(args.seed or 0) + i)
                             if sample_kw else {}),
                          **_priority(i))
            for i in range(args.requests)]
    results = engine.run()
    for uid in uids:
        print(f"req {uid:3d}: {results[uid]}")
    if not reference:
        print(f"stats: {engine.stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
