"""Minimal streaming client for the serving engine.

``ServeEngine.submit`` returns a ``RequestHandle`` (an int-compatible
object carrying the request uid).  ``handle.tokens()`` yields generated
tokens as they are emitted, driving ``engine.tick()`` whenever it starves —
no thread, no callback: the engine stays a pull-based tick loop, and a tick
advances EVERY live request, so several handles can be consumed
concurrently (here: round-robin across three streams).

The second half is the cancel-on-timeout pattern: a long generation is
cancelled mid-decode once its wall-clock budget expires.  ``cancel()``
releases the request's pages refcount-safely — pages shared with other
requests (or held by the prefix cache) survive — so the demo ends by
asserting the pool is fully reclaimable: nothing leaked.

  PYTHONPATH=src python -m repro_torch.examples.serve_stream [--device cpu]
"""
import argparse
import time

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
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = M.init_params(cfg, generator=torch.Generator(device).manual_seed(0),
                           device=device)
    eng = ServeEngine(params, cfg, batch_size=3, cache_len=128,
                      page_size=8, prefill_chunk=16, token_budget=32,
                      device=device)
    rng = np.random.RandomState(0)

    # -- streaming: three concurrent requests, consumed token by token ----
    handles = [eng.submit(rng.randint(0, cfg.vocab_size, n), max_tokens=6)
               for n in (12, 7, 19)]
    streams = [(h, h.tokens()) for h in handles]
    print("streaming three requests (one line per token):")
    while streams:
        for h, it in list(streams):
            tok = next(it, None)
            if tok is None:
                print(f"  req {h:3d}: done -> {h.result()}")
                streams.remove((h, it))
            else:
                print(f"  req {h:3d}: +{tok}")

    # -- cancel on timeout: stop a runaway generation mid-decode ----------
    # a real client would use only the wall-clock deadline; the token cap
    # keeps the demo deterministic on machines fast enough to finish 100
    # tokens before the clock expires
    slow = eng.submit(rng.randint(0, cfg.vocab_size, 10), max_tokens=100)
    deadline = time.perf_counter() + 0.25
    for i, tok in enumerate(slow.tokens()):
        if time.perf_counter() > deadline or i >= 11:
            slow.cancel()
            break
    print(f"cancelled after {len(slow.result())} tokens "
          f"(cancelled={slow.cancelled})")
    assert slow.cancelled and len(slow.result()) < 100
    eng.run()  # drain anything still live

    # cancellation is refcount-safe: every page is free or reclaimable cache
    assert eng.reclaimable_pages == eng.n_pages, "page leak!"
    print(f"pool clean: {eng.reclaimable_pages}/{eng.n_pages} pages "
          f"reclaimable; stats: prefix_hits={eng.stats['prefix_hits']}, "
          f"cancelled={eng.stats['cancelled']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
