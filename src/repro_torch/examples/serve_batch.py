"""Serve mixed-length batched requests through the ragged token-budget
engine (one captured step for any prefill/decode mix + paged KV slots +
FIFO admission).

  PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("gemma3-4b", smoke=True)  # local+global attention mix
    params = M.init_params(cfg, generator=torch.Generator(device).manual_seed(0),
                           device=device)
    # 4 slots, but a page pool sized for ~2.5 full sequences: admission
    # reserves pages FIFO and queues the rest — overcommit without OOM
    engine = ServeEngine(params, cfg, batch_size=4, cache_len=96,
                         page_size=16, max_pages=16, prefill_chunk=32,
                         device=device)

    rng = np.random.RandomState(0)
    uids = [engine.submit(rng.randint(0, cfg.vocab_size, size=L),
                          max_tokens=8)
            for L in (12, 48, 7, 80, 25, 12, 60, 9, 33, 16)]
    results = engine.run()
    for uid in uids:
        print(f"request {uid:2d} -> {results[uid]}")
    assert len(results) == 10 and all(len(v) == 8 for v in results.values())
    print(f"served 10 mixed-length requests through 4 slots / 16 pages: "
          f"{engine.stats}")
    return results


if __name__ == "__main__":
    main()
