"""Serving-engine sweep of the PyTorch port — the Figs. 4/5 protocol at
serving time.

A copy of the JAX package's root ``benchmarks/serve_sweep.py`` driving the
port's engines (``repro_torch.serve``), with its scenarios, rows, CLI flags
and JSON keys.  Its engines take the JAX sweep's settings (``flash_decode``
stays at its default, as there), and the sweep's weights are seed-0
random parameters from ``models.model.init_params`` on ``--device``
(``cuda`` by default; ``--device cpu`` rehearses on the CPU).  The
tensor-parallel scenario (``--sharded``, ``--sharded-only``) waits for
``ServeEngine(mesh=)`` and raises ``NotImplementedError`` (ROADMAP.md,
Queue 1, multi-GPU).

The paper sweeps (Nproc × Nthread) at constant memory and shows that one
set of system settings keeps every factorization near peak.  The serving
analogue sweeps (concurrent users × prompt-length mix × page size) through
``serve.ServeEngine`` and scores measured tokens/s four ways:

- against the seed engine (``serve.reference.ReferenceEngine``, batch-1
  sequential prefill) on identical traffic — the speedup column;
- **ragged vs chunked** — the same traffic through the single-program
  ragged token-budget engine and the two-phase engine
  (``ragged=False``), the serving analogue of one-configuration-for-all
  (Nproc × Nthread) vs per-point retuning;
- against the analytic mixed roofline (``core.roofline.mixed_bound``) at
  the tick's decode/prefill blend — the fraction-of-bound column;
- **p50 decode latency under concurrent prefill** — a chat+document
  workload in which long prompts stream through the slots while short chats
  decode; the two-phase engine stalls every decoder for the length of each
  prefill burst, the ragged engine packs decode tokens into every tick.
- **prefix-cache on/off under continuous Poisson arrivals** — the paper's
  cache-mode experiment at serving time: requests sharing one system
  prompt arrive per-tick (exponential gaps, driven through the public
  ``ServeEngine.tick`` API rather than batch drain), and the refcounted
  prefix cache serves the warm prefix from resident pages instead of
  re-prefilling it.  Reports tokens/s sharing-on vs sharing-off plus
  ``prefix_hit_rate`` / ``tokens_reused``, and checks greedy outputs stay
  token-identical to the seed reference engine.
- **tiered KV cache A/B (drop-on-evict vs host-tier)** — the paper's
  cache-mode experiment applied to the page pool itself: a prefix working
  set larger than the device pool is replayed warm; the untiered arm
  re-prefills every evicted prefix, the tiered arm promotes demoted pages
  back from the host tier.  Reports replay tokens/s per arm, the
  device/host/miss admission split, pages promoted, and the token-identity
  check (tiering moves bytes, never changes them).  ``--tiered-only`` runs
  just this scenario.
- **speculative decoding A/B (spec-off vs prompt-lookup drafts)** — the
  repetitive code/doc-completion workload: tiled-pattern prompts whose
  greedy continuations the n-gram drafter predicts almost perfectly, so
  the spec-on arm verifies ``spec_k`` draft tokens per decoding slot in
  the same one-trace (T,) pack and emits >1 accepted token per slot-tick.
  Reports per arm tokens/s + the draft ledger, ``accepted_per_tick``,
  token-identity of greedy transcripts (verification is exact), and the
  page-leak gate after a cancel-mid-draft wave.  ``--spec-only`` runs just
  this scenario.
- **preemption A/B (preempt vs admission-stall)** — the graceful-
  degradation experiment: an overload wave of deadline-bound interactive
  chats arrives while long batch hogs fill an undersized pool exactly.
  The stall arm queues the chats behind the hogs (tight deadlines expire
  un-served); the preempt arm parks a hog's private KV to the host tier,
  serves the chat inside its deadline, and resumes the hog token-
  identically.  Reports per arm SLO goodput (deadline-met interactive
  tokens/s), p50 interactive latency, and the preempt/resume ledger; gates
  transcripts identical to an unconstrained run, zero leaked pages on both
  tiers, one trace, and preempt goodput >= 1.2x stall.  A fault-injected
  chaos sub-run (``serve.chaos.FaultInjector``) holds the same no-leak +
  identity line off the happy path.  ``--preempt-only`` runs just this
  scenario.
- **fp32-vs-int8 KV pool A/B at a fixed page-pool BYTE budget** — the
  quantized-working-set experiment: both arms get the same pool bytes, so
  the int8 arm holds 2-4× the resident pages and admits more concurrent
  decoders on decode-heavy traffic (throughput + greedy top-1 agreement +
  p50 decode gap + max-resident-pages per arm), plus a warm-prefix pass
  on the int8 pool (hits must stay token-identical to the int8 cold path
  — quantize-at-write means a cached page replays exactly).
- **scheduler A/B (fifo vs prefix-aware vs slo)** — the pluggable-policy
  experiment on mixed shared-prefix Poisson traffic: three document
  families (long shared prefix each, batch class) interleaved with
  interactive chats, through a page pool deliberately too small to keep
  every family's prefix resident.  FIFO's arrival order ping-pongs the
  cache between families (evictions, cold re-prefill); the prefix-aware
  window groups each family into the same admission wave so its prefix is
  reused while resident; the slo policy admits and packs the interactive
  class first.  Reports per policy: tokens/s, prefix tokens reused,
  evictions, packed tokens, and p50/p99 interactive token latency (mean
  wall time per emitted token since submit, per interactive request — the
  queue-jump metric).

The JSON payload also records ``tuned_serving_config`` — the single
(token_budget, prefill_chunk, page_size, kv_dtype, scheduler) point that
``core.autotune.select_serve_defaults`` picks from the analytic roofline
sweep ("set it once system-wide", memory representation and scheduling
policy included).

  PYTHONPATH=src python -m repro_torch.benchmarks.serve_sweep
      [--arch qwen2-1.5b] [--users 4 16] [--page-sizes 8 32]
      [--max-tokens 8] [--no-baseline] [--smoke] [--json PATH]
      [--device cpu]

CSV: name,tokens_per_s,derived  (derived = ×-over-seed / ×-over-chunked /
%-of-bound / latency ratio / prefix hit rate).  ``--json`` additionally
writes the rows + latency + prefix-scenario results machine-readably.
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.roofline import mixed_bound
from repro_torch.models import model as M
from repro_torch.serve.chaos import FaultInjector
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import Cancelled, DeadlineExceeded
from repro_torch.serve.pool import kv_page_bytes
from repro_torch.serve.reference import ReferenceEngine

# mixed-length mix: short chat turns + a few long-context stragglers
# (fractions of cache budget available for the prompt)
MIX = (0.15, 0.7, 0.3, 0.15, 0.5, 0.9, 0.2, 0.4)


def _traffic(cfg, n_users: int, prompt_budget: int, max_tokens: int, seed=0):
    rng = np.random.RandomState(seed)
    prompts = []
    for i in range(n_users):
        L = max(4, int(MIX[i % len(MIX)] * prompt_budget))
        prompts.append(rng.randint(0, cfg.vocab_size, L))
    return prompts


def _run(engine, prompts, max_tokens: int):
    uids = [engine.submit(p, max_tokens=max_tokens) for p in prompts]
    t0 = time.perf_counter()
    results = engine.run()
    # on a card the clock reads finished work: a drain ends on a tick that
    # booked its requests' last tokens, and booking samples on the host
    # from logits the tick's step fetched after waiting for it (under graph
    # replay too: the fetch records and waits on an event behind the
    # replay, serve_step.CapturedStep.fetch; the lock-step engine copies
    # its argmax to the host); a speculative tick's rollback replays only
    # for slots still live, so none is left behind the last booking
    dt = time.perf_counter() - t0
    n_tok = sum(len(results[u]) for u in uids)
    assert all(len(results[u]) == max_tokens for u in uids)
    return n_tok / dt, results


def _p50_token_gap_ms(eng, skip: int = 0,
                      under_prefill_only: bool = False) -> float:
    """p50 wall-time gap between consecutive tokens of one request.

    ``under_prefill_only`` counts only gaps spanning >= 1 tick with
    outstanding prefill work (decode latency UNDER CONCURRENT PREFILL — the
    head-of-line metric); ``skip`` drops log entries from a warmup run on
    the same engine (the kv-dtype A/B warms in place)."""
    last = {}
    gaps = []
    for uid, tick, t in eng.token_log[skip:]:
        if uid in last:
            t0, tick0 = last[uid]
            if (not under_prefill_only
                    or any(hp for hp, _ in eng.tick_log[tick0 + 1:tick + 1])):
                gaps.append(t - t0)
        last[uid] = (t, tick)
    return float(np.median(gaps) * 1e3) if gaps else float("nan")


def latency_scenario(cfg, params, *, cache_len: int, warm: bool = True):
    """Chat + document stream: 2 short chats decode continuously while long
    prompts churn through the other slots.  Returns per-engine p50 decode
    latency (ms) under concurrent prefill, plus tokens/s on the workload."""
    chat_len, chat_toks = 8, 24
    doc_len, doc_toks, n_docs = int(cache_len * 0.85), 2, 6
    rng = np.random.RandomState(11)
    chats = [rng.randint(0, cfg.vocab_size, chat_len) for _ in range(2)]
    docs = [rng.randint(0, cfg.vocab_size, doc_len) for _ in range(n_docs)]

    out = {}
    for mode in ("chunked", "ragged"):
        def make():
            return ServeEngine(params, cfg, batch_size=4, cache_len=cache_len,
                               page_size=16, prefill_chunk=32,
                               token_budget=128, ragged=(mode == "ragged"),
                               device=params.device)

        def drive(eng):
            uids = ([eng.submit(p, max_tokens=chat_toks) for p in chats]
                    + [eng.submit(p, max_tokens=doc_toks) for p in docs])
            t0 = time.perf_counter()
            results = eng.run()
            dt = time.perf_counter() - t0
            return sum(len(results[u]) for u in uids) / dt

        if warm:
            drive(make())
        eng = make()
        tps = drive(eng)
        out[mode] = {"p50_decode_ms_under_prefill": _p50_token_gap_ms(
                         eng, under_prefill_only=True),
                     "tokens_per_s": tps,
                     "ticks": eng.stats["ticks"]}
    return out


def prefix_scenario(cfg, params, *, cache_len: int, n_requests: int = 12,
                    rate: float = 1.5, max_tokens: int = 4, seed: int = 13,
                    check_reference: bool = True):
    """Shared-system-prompt serving under continuous per-tick arrivals.

    ``n_requests`` requests — one long shared system prompt plus a short
    unique user suffix each — arrive with exponential inter-arrival gaps
    (a Poisson process at ``rate`` requests/tick), submitted mid-flight
    through ``ServeEngine.tick``.  Each engine is driven twice: the first
    pass builds the steps and (for prefix-on) populates the cache, the
    second is the measured warm run — the steady state of a long-running
    server.

    Returns {"prefix-on": {...}, "prefix-off": {...}, "speedup",
    "token_identical"} with per-mode tokens/s and cache counters.
    """
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, cfg.vocab_size, int(cache_len * 0.75))
    prompts = [np.concatenate([sys_prompt,
                               rng.randint(0, cfg.vocab_size,
                                           rng.randint(3, 9))])
               for _ in range(n_requests)]
    arrive_tick = np.floor(np.cumsum(
        rng.exponential(1.0 / rate, size=n_requests))).astype(int)

    out = {}
    outputs = {}
    for mode in ("prefix-off", "prefix-on"):
        eng = ServeEngine(params, cfg, batch_size=4, cache_len=cache_len,
                          page_size=16, prefill_chunk=32, token_budget=128,
                          prefix_cache=(mode == "prefix-on"),
                          device=params.device)

        def drive():
            uids, done, i, tick = [], {}, 0, 0
            t0 = time.perf_counter()
            while i < n_requests or not eng.idle:
                while i < n_requests and arrive_tick[i] <= tick:
                    uids.append(eng.submit(prompts[i],
                                           max_tokens=max_tokens))
                    i += 1
                done.update(eng.tick())
                tick += 1
                assert tick < 100_000, "prefix scenario failed to drain"
            dt = time.perf_counter() - t0
            n_tok = sum(len(done[u]) for u in uids)
            assert all(len(done[u]) == max_tokens for u in uids)
            return n_tok / dt, [done[u] for u in uids]

        drive()  # cold: build the steps + populate the prefix cache
        before = dict(eng.stats)
        tps, outputs[mode] = drive()  # measured warm run
        adm = eng.stats["admissions"] - before["admissions"]
        hits = eng.stats["prefix_hits"] - before["prefix_hits"]
        out[mode] = {
            "tokens_per_s": tps,
            "prefix_hit_rate": hits / max(adm, 1),
            "tokens_reused": (eng.stats["prefix_tokens_reused"]
                              - before["prefix_tokens_reused"]),
            "cow_copies": eng.stats["cow_copies"] - before["cow_copies"],
            "evictions": eng.stats["evictions"] - before["evictions"],
            "cached_pages": eng.cached_pages,
            "ticks": eng.stats["ticks"] - before["ticks"],
            "traces": eng.stats["traces"],
        }
    identical = outputs["prefix-on"] == outputs["prefix-off"]
    if check_reference:  # greedy identity against the seed engine, solo
        ref = ReferenceEngine(params, cfg, batch_size=1, cache_len=cache_len,
                              device=params.device)
        ref_uids = [ref.submit(p, max_tokens=max_tokens) for p in prompts]
        want = ref.run(max_ticks=8192)
        identical &= outputs["prefix-on"] == [want[u] for u in ref_uids]
    return {**out,
            "speedup": (out["prefix-on"]["tokens_per_s"]
                        / out["prefix-off"]["tokens_per_s"]),
            "token_identical": bool(identical)}


def scheduler_ab_scenario(cfg, params, *, cache_len: int = 256,
                          n_families: int = 3, family_size: int = 4,
                          n_chats: int = 6, rate: float = 1.2,
                          seed: int = 19, warm: bool = True):
    """fifo vs prefix-aware vs slo on mixed shared-prefix Poisson traffic.

    Traffic: ``n_families`` document families — one long shared prefix (10
    full pages) plus a short unique suffix per request, batch class
    (priority 0, ``max_tokens=4``) — interleaved round-robin so consecutive
    arrivals belong to DIFFERENT families, plus ``n_chats`` interactive
    chats (6-token prompts, priority 1, ``max_tokens=3``) spread through
    the stream.  Arrivals are Poisson (``rate`` requests/tick) driven
    through ``ServeEngine.tick``.  The page pool is sized so roughly half
    the family prefixes fit at once: under FIFO the interleaved families
    evict each other's cached prefix before the next sibling arrives
    (cold re-prefill every time), the prefix-aware window groups a family
    into consecutive admissions so its prefix is reused while resident,
    and slo admits/packs the interactive class first.

    Interactive token latency is the queue-jump metric: per interactive
    request, (last token wall time - submit wall time) / tokens emitted —
    time-to-first-token and inter-token gaps folded into one number that a
    policy can only improve by actually admitting the chat sooner.

    Returns {"fifo": {...}, "prefix-aware": {...}, "slo": {...},
    "prefix_aware_speedup", "slo_p50_latency_ratio", "token_identical"}.
    """
    rng = np.random.RandomState(seed)
    page = 16
    prefix_pages = 10
    fams = [rng.randint(0, cfg.vocab_size, prefix_pages * page)
            for _ in range(n_families)]
    docs = [(f, np.concatenate([fams[f],
                                rng.randint(0, cfg.vocab_size,
                                            rng.randint(5, 9))]))
            for _ in range(family_size) for f in range(n_families)]
    chats = [rng.randint(0, cfg.vocab_size, 6) for _ in range(n_chats)]
    # interleave: after every len(fams) docs (one per family), one chat
    stream = []
    di = ci = 0
    while di < len(docs) or ci < len(chats):
        for _ in range(n_families):
            if di < len(docs):
                stream.append(("doc", docs[di][1]))
                di += 1
        if ci < len(chats):
            stream.append(("chat", chats[ci]))
            ci += 1
    arrive_tick = np.floor(np.cumsum(
        rng.exponential(1.0 / rate, size=len(stream)))).astype(int)
    # pool: one live wave (2 slots × 11-page doc footprint) plus ~ONE cached
    # family prefix — too small for every family to stay resident
    max_pages = 2 * (prefix_pages + 1) + 2

    out = {}
    outputs = {}
    for sched in ("fifo", "prefix-aware", "slo"):
        eng = ServeEngine(params, cfg, batch_size=2, cache_len=cache_len,
                          page_size=page, prefill_chunk=32, token_budget=128,
                          max_pages=max_pages, scheduler=sched,
                          device=params.device)
        if warm:  # build outside the measurement, then forget the pages
            eng.submit(rng.randint(0, cfg.vocab_size, 20), max_tokens=2)
            eng.run()
            eng.drop_prefix_cache()
        before = dict(eng.stats)
        skip = len(eng.token_log)
        submit_t = {}
        kinds = {}
        done = {}
        uids = []
        i, tick = 0, 0
        t0 = time.perf_counter()
        while i < len(stream) or not eng.idle:
            while i < len(stream) and arrive_tick[i] <= tick:
                kind, prompt = stream[i]
                h = eng.submit(prompt,
                               max_tokens=3 if kind == "chat" else 4,
                               priority=1 if kind == "chat" else 0)
                submit_t[int(h)] = time.perf_counter()
                kinds[int(h)] = kind
                uids.append(int(h))
                i += 1
            done.update(eng.tick())
            tick += 1
            assert tick < 100_000, "scheduler scenario failed to drain"
        dt = time.perf_counter() - t0
        n_tok = sum(len(done[u]) for u in uids)
        # per-interactive-request mean wall time per emitted token, from
        # submit (admission wait + prefill + decode gaps in one number)
        last_t = {}
        n_seen = {}
        for uid, _, t in eng.token_log[skip:]:
            last_t[uid] = t
            n_seen[uid] = n_seen.get(uid, 0) + 1
        lat = [(last_t[u] - submit_t[u]) / n_seen[u] * 1e3
               for u in uids if kinds[u] == "chat"]
        outputs[sched] = [done[u] for u in uids]
        out[sched] = {
            "tokens_per_s": n_tok / dt,
            "p50_interactive_ms": float(np.percentile(lat, 50)),
            "p99_interactive_ms": float(np.percentile(lat, 99)),
            "packed_tokens": eng.stats["packed_tokens"]
                             - before["packed_tokens"],
            "prefix_tokens_reused": eng.stats["prefix_tokens_reused"]
                                    - before["prefix_tokens_reused"],
            "evictions": eng.stats["evictions"] - before["evictions"],
            "prefix_hits": eng.stats["prefix_hits"] - before["prefix_hits"],
            "ticks": eng.stats["ticks"] - before["ticks"],
            "traces": eng.stats["traces"],
        }
    # greedy outputs are schedule-invariant: a request's tokens depend only
    # on its prompt (prefix reuse is exact), never on admission order
    identical = (outputs["fifo"] == outputs["prefix-aware"]
                 == outputs["slo"])
    return {**out,
            "prefix_aware_speedup": (out["prefix-aware"]["tokens_per_s"]
                                     / out["fifo"]["tokens_per_s"]),
            "slo_p50_latency_ratio": (out["slo"]["p50_interactive_ms"]
                                      / out["fifo"]["p50_interactive_ms"]),
            "token_identical": bool(identical)}


def tiered_kv_scenario(cfg, params, *, page_size: int = 8,
                       n_families: int = 3, prefix_pages: int = 6,
                       max_tokens: int = 4, seed: int = 29,
                       warm: bool = True):
    """Tiered KV cache A/B — the paper's cache-vs-flat experiment at
    serving time.

    Traffic: ``n_families`` prompts of ``prefix_pages`` full pages each —
    a prefix working set deliberately LARGER than the device pool — driven
    twice through each arm (cold populate, then the measured warm replay).
    The drop-on-evict arm (``host_pages=0``) loses every prefix to
    allocation pressure before its replay arrives and re-prefills from
    scratch; the tiered arm (``host_pages``>0) demoted those pages to host
    RAM, so every replay is a HOST hit promoted back — only the decode
    ticks remain.

    Reports per arm: replay tokens/s, the admission hit split
    (device / host / miss), pages promoted, tier traffic counters; plus
    ``speedup`` (tiered over drop-on-evict replay tokens/s),
    ``host_hit_rate`` on the tiered replay, and ``token_identical`` across
    arms AND waves (tiering moves bytes, never changes them)."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, prefix_pages * page_size)
               for _ in range(n_families)]
    footprint = prefix_pages + -(-max_tokens // page_size)
    # device pool: ONE request's footprint — far below the n_families *
    # prefix_pages working set, so every admission evicts (or demotes) the
    # previous family's whole prefix and an untiered replay always misses
    max_pages = footprint
    cache_len = (prefix_pages + 1) * page_size

    out = {}
    outputs = {}
    for mode, host in (("drop-on-evict", 0),
                       ("host-tier", 2 * n_families * prefix_pages)):
        eng = ServeEngine(params, cfg, batch_size=1, cache_len=cache_len,
                          page_size=page_size, prefill_chunk=page_size,
                          token_budget=32, max_pages=max_pages,
                          host_pages=host, device=params.device)

        def drive():
            uids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
            t0 = time.perf_counter()
            results = eng.run()
            dt = time.perf_counter() - t0
            n_tok = sum(len(results[u]) for u in uids)
            assert all(len(results[u]) == max_tokens for u in uids)
            return n_tok / dt, [results[u] for u in uids]

        if warm:  # build every step (movers included), then forget
            drive()
            drive()
            eng.drop_prefix_cache()
        _, cold_out = drive()  # populate: cold prefill, pressure demotes
        before = dict(eng.stats)
        tps, replay_out = drive()  # measured warm replay
        adm = eng.stats["admissions"] - before["admissions"]
        hits = eng.stats["prefix_hits"] - before["prefix_hits"]
        host_hits = eng.stats["host_hits"] - before["host_hits"]
        outputs[mode] = cold_out + replay_out
        delta = {k: eng.stats[k] - before[k]
                 for k in ("host_pages_promoted", "demotions",
                           "host_evictions", "evictions", "ticks")}
        # replay is a steady state (each wave re-demotes what it promoted,
        # or re-prefills what it dropped): best-of-3 damps wall-clock noise
        for _ in range(2):
            t2, r2 = drive()
            assert r2 == replay_out
            tps = max(tps, t2)
        out[mode] = {
            "tokens_per_s": tps,
            "host_pool_pages": host,
            "replay_admissions": adm,
            "hit_split": {"device": hits - host_hits, "host": host_hits,
                          "miss": adm - hits},
            "host_hit_rate": host_hits / max(adm, 1),
            "pages_promoted": delta["host_pages_promoted"],
            "demotions": delta["demotions"],
            "host_evictions": delta["host_evictions"],
            "evictions": delta["evictions"],
            "ticks": delta["ticks"],
            "traces": eng.stats["traces"],
        }
    identical = (outputs["host-tier"] == outputs["drop-on-evict"]
                 and outputs["host-tier"][:n_families]
                 == outputs["host-tier"][n_families:])
    return {**out,
            "speedup": (out["host-tier"]["tokens_per_s"]
                        / out["drop-on-evict"]["tokens_per_s"]),
            "host_hit_rate": out["host-tier"]["host_hit_rate"],
            "token_identical": bool(identical)}


def speculative_scenario(cfg, params, *, batch_size: int = 4,
                         page_size: int = 8, spec_k: int = 6,
                         pattern_len: int = 6, reps: int = 8,
                         max_tokens: int = 48, seed: int = 31,
                         warm: bool = True):
    """Speculative decoding A/B on the repetitive code/doc-completion
    workload — the prompt-lookup drafter's home turf.

    Traffic: ``batch_size`` prompts, each a short token pattern tiled
    ``reps`` times (the structure of boilerplate code or templated docs).
    A greedy model decoding such a prompt settles into a loop the n-gram
    drafter predicts almost perfectly, so the spec-on arm packs ``spec_k``
    draft tokens per decoding slot into the SAME (T,) budget and accepts
    most of them — more than one emitted token per slot-tick through one
    forward pass per tick, with zero extra traces.

    Reports per arm: tokens/s (best-of-3 warm), ticks, traces, and for the
    spec arm the draft ledger (drafted/accepted/rejected/rollbacks) plus
    ``accepted_per_tick`` — mean emitted tokens per (request, tick) pair
    computed from the measured segment of ``token_log`` (the >1 gate);
    ``speedup`` (spec-on over spec-off tokens/s), ``token_identical``
    (greedy transcripts must match exactly — verification is exact), and
    ``page_leak_free`` after a cancel-mid-draft wave (half the requests
    cancelled while draft chains are in flight, then a full drain)."""
    rng = np.random.RandomState(seed)
    prompts = [np.tile(rng.randint(0, cfg.vocab_size, pattern_len), reps)
               for _ in range(batch_size)]
    prompt_len = pattern_len * reps
    cache_len = prompt_len + max_tokens + 2 * page_size

    out = {}
    outputs = {}
    for mode, k in (("spec-off", 0), ("spec-on", spec_k)):
        eng = ServeEngine(params, cfg, batch_size=batch_size,
                          cache_len=cache_len, page_size=page_size,
                          prefill_chunk=16,
                          token_budget=batch_size * (1 + spec_k) + 16,
                          spec_k=k, device=params.device)

        def drive():
            uids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
            log0 = len(eng.token_log)
            t0 = time.perf_counter()
            results = eng.run()
            dt = time.perf_counter() - t0
            n_tok = sum(len(results[u]) for u in uids)
            assert all(len(results[u]) == max_tokens for u in uids)
            slot_ticks = {(uid, tick)
                          for uid, tick, _ in eng.token_log[log0:]}
            return (n_tok / dt, [results[u] for u in uids],
                    n_tok / max(len(slot_ticks), 1))
        if warm:  # build every step (rollback included), then re-time
            drive()
        before = dict(eng.stats)
        tps, toks, acc_tick = drive()
        delta = {s: eng.stats[s] - before[s]
                 for s in ("ticks", "spec_drafted", "spec_accepted",
                           "spec_rejected", "spec_rollbacks")}
        outputs[mode] = toks
        for _ in range(2):  # best-of-3 damps wall-clock noise
            t2, r2, _ = drive()
            assert r2 == toks
            tps = max(tps, t2)
        # cancel-mid-draft wave: half the requests die while draft chains
        # are in flight; the drain must hand every page back
        handles = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
        for _ in range(3):
            eng.tick()
        for h in handles[::2]:
            h.cancel()
        eng.run()
        leak_free = bool((eng._ref == 0).all()
                         and eng.reclaimable_pages == eng.n_pages)
        out[mode] = {
            "tokens_per_s": tps,
            "spec_k": k,
            "ticks": delta["ticks"],
            "accepted_per_tick": acc_tick,
            "drafted": delta["spec_drafted"],
            "accepted": delta["spec_accepted"],
            "rejected": delta["spec_rejected"],
            "rollbacks": delta["spec_rollbacks"],
            "page_leak_free": leak_free,
            "traces": eng.stats["traces"],
        }
    return {**out,
            "speedup": (out["spec-on"]["tokens_per_s"]
                        / out["spec-off"]["tokens_per_s"]),
            "accepted_per_tick": out["spec-on"]["accepted_per_tick"],
            "token_identical": bool(outputs["spec-on"]
                                    == outputs["spec-off"]),
            "page_leak_free": bool(out["spec-on"]["page_leak_free"]
                                   and out["spec-off"]["page_leak_free"])}


def preemption_scenario(cfg, params, *, page_size: int = 8,
                        n_hogs: int = 2, hog_tokens: int = 48,
                        n_chats: int = 6, chat_tokens: int = 4,
                        tight_deadline: int = 30, loose_deadline: int = 80,
                        seed: int = 37, warm: bool = True,
                        chaos: bool = True):
    """Preemption A/B — an overload wave through an undersized pool.

    Traffic: ``n_hogs`` batch requests (priority 0, long ``hog_tokens``
    decode) sized so their footprints fill the device pool EXACTLY, then an
    interactive wave (priority 1, ``deadline_ticks=`` alternating tight /
    loose) arriving while both slots decode hogs.  The stall arm
    (``preempt=False``) can only queue the chats behind the hogs: every
    tight-deadline chat expires un-served, the loose ones queue-jump only
    once a hog finishes.  The preempt arm parks a hog's private KV to the
    host tier, serves the chat inside its deadline, then
    promotes the hog back and finishes it — same transcripts, tokens moved
    not changed.

    Goodput is the SLO metric: interactive tokens delivered WITHIN their
    deadline per second (batch tokens are best-effort and reported in
    ``tokens_per_s``).  Gates: completed transcripts token-identical to an
    unconstrained (big-pool, no-deadline) run in every arm, zero leaked
    pages on both tiers, ``traces == 1`` through preempt/resume cycles,
    preempt goodput >= 1.2x stall, p50 interactive latency no worse than
    the stall arm's.  ``chaos=True`` adds a fault-injected sub-run
    (``serve.chaos.FaultInjector``: alloc failures, random cancels, host
    eviction storms, stalled ticks) holding the same no-leak + identity
    line off the happy path.  ``--preempt-only`` runs just this
    scenario."""
    rng = np.random.RandomState(seed)
    hog_prompts = [rng.randint(0, cfg.vocab_size, 3 * page_size)
                   for _ in range(n_hogs)]
    chat_prompts = [rng.randint(0, cfg.vocab_size, 6)
                    for _ in range(n_chats)]
    hog_fp = 3 + -(-hog_tokens // page_size)
    # pool: exactly the hogs' footprints — a chat can only enter by
    # preemption (or by waiting a whole hog out)
    max_pages = n_hogs * hog_fp
    cache_len = 3 * page_size + hog_tokens + page_size
    deadlines = [tight_deadline if j % 2 == 0 else loose_deadline
                 for j in range(n_chats)]
    stream = ([(0, "hog", i) for i in range(n_hogs)]
              + [(4 + j, "chat", j) for j in range(n_chats)])

    def make_engine(preempt, fault_injector=None, big=False):
        return ServeEngine(params, cfg, batch_size=2, cache_len=cache_len,
                           page_size=page_size, prefill_chunk=3 * page_size,
                           token_budget=3 * page_size + 8,
                           max_pages=4 * max_pages if big else max_pages,
                           host_pages=2 * max_pages, scheduler="slo",
                           preempt=preempt, fault_injector=fault_injector,
                           device=params.device)

    def drive(eng, with_deadlines=True):
        handles, submit_t = {}, {}
        i, tick = 0, 0
        t0 = time.perf_counter()
        while i < len(stream) or not eng.idle:
            while i < len(stream) and stream[i][0] <= tick:
                _, kind, j = stream[i]
                if kind == "hog":
                    h = eng.submit(hog_prompts[j], max_tokens=hog_tokens)
                else:
                    h = eng.submit(chat_prompts[j], max_tokens=chat_tokens,
                                   priority=1,
                                   deadline_ticks=(deadlines[j]
                                                   if with_deadlines
                                                   else None))
                handles[(kind, j)] = h
                submit_t[(kind, j)] = time.perf_counter()
                i += 1
            eng.tick()
            tick += 1
            assert tick < 100_000, "preemption scenario failed to drain"
        return time.perf_counter() - t0, handles, submit_t

    def completed_of(handles):
        return {k: list(h.request.out_tokens) for k, h in handles.items()
                if h.request.done and h.request.error is None
                and not h.request.cancelled}

    def leak_free(eng):
        pool = eng.pool
        return bool((eng._ref == 0).all()
                    and eng.reclaimable_pages == eng.n_pages
                    and pool.parked_pages == 0
                    and len(pool._host_free) + pool.host_cached_pages
                    == pool.host_pages
                    and eng._host_slots == set(pool._host_node))

    # unconstrained reference transcripts: big pool, no deadlines, no
    # pressure — what every request SHOULD say whenever it completes
    ref = make_engine(False, big=True)
    uids = ([ref.submit(p, max_tokens=hog_tokens) for p in hog_prompts]
            + [ref.submit(p, max_tokens=chat_tokens, priority=1)
               for p in chat_prompts])
    res = ref.run()
    expect = {("hog", i): res[uids[i]] for i in range(n_hogs)}
    expect.update({("chat", j): res[uids[n_hogs + j]]
                   for j in range(n_chats)})

    out = {}
    for mode, preempt in (("stall", False), ("preempt", True)):
        eng = make_engine(preempt)
        if warm:  # build every step (park/unpark movers included)
            drive(eng)
            eng.drop_prefix_cache()
        before = dict(eng.stats)
        skip = len(eng.token_log)
        dt, handles, submit_t = drive(eng)
        completed = completed_of(handles)
        # queue-jump metric over COMPLETED chats only (expired ones never
        # produced a served token): mean wall time per token since submit
        last_t, n_seen = {}, {}
        for uid, _, t in eng.token_log[skip:]:
            last_t[uid] = t
            n_seen[uid] = n_seen.get(uid, 0) + 1
        lat = [(last_t[int(h)] - submit_t[k]) / n_seen[int(h)] * 1e3
               for k, h in handles.items()
               if k[0] == "chat" and k in completed and int(h) in last_t]
        delta = {s: eng.stats[s] - before[s]
                 for s in ("ticks", "preemptions", "resumes",
                           "resume_park_hits", "resume_reprefills",
                           "preempt_pages_parked", "deadline_expired")}
        out[mode] = {
            "goodput_tokens_per_s": sum(
                len(v) for k, v in completed.items()
                if k[0] == "chat") / dt,
            "tokens_per_s": sum(len(v) for v in completed.values()) / dt,
            "interactive_completed": sum(1 for k in completed
                                         if k[0] == "chat"),
            "interactive_expired": sum(
                1 for h in handles.values()
                if isinstance(h.request.error, DeadlineExceeded)),
            "p50_interactive_ms": (float(np.percentile(lat, 50))
                                   if lat else float("nan")),
            **delta,
            "traces": eng.stats["traces"],
            "token_identical": bool(all(completed[k] == expect[k]
                                        for k in completed)),
            "page_leak_free": leak_free(eng),
        }

    result = {**out,
              "goodput_ratio": (out["preempt"]["goodput_tokens_per_s"]
                                / max(out["stall"]["goodput_tokens_per_s"],
                                      1e-9)),
              "p50_interactive_ratio": (out["preempt"]["p50_interactive_ms"]
                                        / out["stall"]["p50_interactive_ms"]),
              "token_identical": bool(out["preempt"]["token_identical"]
                                      and out["stall"]["token_identical"]),
              "page_leak_free": bool(out["preempt"]["page_leak_free"]
                                     and out["stall"]["page_leak_free"])}
    if chaos:
        fi = FaultInjector(seed=5, p_alloc_fail=0.15, p_cancel=0.05,
                           p_evict_storm=0.1, p_stall=0.1)
        eng = make_engine(True, fault_injector=fi)
        before = dict(eng.stats)
        _, handles, _ = drive(eng)
        completed = completed_of(handles)
        result["chaos"] = {
            "completed": len(completed),
            "cancelled": sum(isinstance(h.request.error, Cancelled)
                             for h in handles.values()),
            "expired": sum(isinstance(h.request.error, DeadlineExceeded)
                           for h in handles.values()),
            "faults_injected": len(fi.log),
            **{s: eng.stats[s] - before[s]
               for s in ("chaos_alloc_fails", "chaos_cancels",
                         "chaos_evict_storms", "chaos_stalled_ticks",
                         "preemptions", "resumes")},
            "traces": eng.stats["traces"],
            "token_identical": bool(all(completed[k] == expect[k]
                                        for k in completed)),
            "page_leak_free": leak_free(eng),
        }
        result["token_identical"] = bool(
            result["token_identical"]
            and result["chaos"]["token_identical"])
        result["page_leak_free"] = bool(
            result["page_leak_free"]
            and result["chaos"]["page_leak_free"])
    return result


def _spec_rows(arch, spec):
    rows = []
    for mode in ("spec-off", "spec-on"):
        r = spec[mode]
        rows.append((f"serve/{arch}/speculative/{mode}", r["tokens_per_s"],
                     f"spec_k={r['spec_k']},ticks={r['ticks']},"
                     f"accepted_per_tick={r['accepted_per_tick']:.2f},"
                     f"accepted={r['accepted']},rejected={r['rejected']}"))
    rows.append((f"serve/{arch}/speculative/speedup", spec["speedup"],
                 f"x-over-spec-off,"
                 f"accepted_per_tick={spec['accepted_per_tick']:.2f},"
                 f"token_identical={str(spec['token_identical']).lower()},"
                 f"page_leak_free={str(spec['page_leak_free']).lower()}"))
    return rows


def _tiered_rows(arch, tiered):
    rows = []
    for mode in ("drop-on-evict", "host-tier"):
        r = tiered[mode]
        split = r["hit_split"]
        rows.append((f"serve/{arch}/tiered/{mode}", r["tokens_per_s"],
                     f"host_pool_pages={r['host_pool_pages']},"
                     f"hit_split=d{split['device']}/h{split['host']}"
                     f"/m{split['miss']},promoted={r['pages_promoted']}"))
    rows.append((f"serve/{arch}/tiered/speedup", tiered["speedup"],
                 f"x-over-drop-on-evict,"
                 f"host_hit_rate={tiered['host_hit_rate']:.2f},"
                 "token_identical="
                 + str(tiered["token_identical"]).lower()))
    return rows


def _preempt_rows(arch, pre):
    rows = []
    for mode in ("stall", "preempt"):
        r = pre[mode]
        rows.append((f"serve/{arch}/preemption/{mode}",
                     r["goodput_tokens_per_s"],
                     f"interactive_completed={r['interactive_completed']},"
                     f"expired={r['interactive_expired']},"
                     f"preemptions={r['preemptions']},"
                     f"resumes={r['resumes']},"
                     f"p50_interactive_ms={r['p50_interactive_ms']:.1f}"))
    ch = pre.get("chaos")
    rows.append((f"serve/{arch}/preemption/goodput_ratio",
                 pre["goodput_ratio"],
                 f"x-over-stall,"
                 f"token_identical={str(pre['token_identical']).lower()},"
                 f"page_leak_free={str(pre['page_leak_free']).lower()},"
                 f"chaos_faults={ch['faults_injected'] if ch else 0}"))
    return rows


def kv_ab_scenario(cfg, params, *, cache_len: int = 64, batch_size: int = 8,
                   page_size: int = 8, seed: int = 17, warm: bool = True):
    """fp32-vs-int8 paged-pool A/B at a FIXED page-pool byte budget.

    Both arms serve identical decode-heavy traffic (short prompts, long
    generations — the regime where per-token KV page reads dominate) with
    the same pool BYTES: the fp32 arm gets pages for ~2 in-flight requests,
    the int8 arm gets however many pages the same bytes buy (~2-4× more,
    scale rows included).  More resident pages means more concurrently
    decoding slots per tick, so int8 throughput beats fp32 at equal bytes —
    the serving analogue of the paper's result that fitting the working set
    in fast memory, not adding compute, is what moves the bound.

    Returns per-grid-point rows {"users", "max_tokens", "fp32": {...},
    "int8": {...}, "top1_agreement", "speedup"} plus a prefix-on-int8
    warm-path check (cached int8 pages must replay token-identically).
    """
    rng = np.random.RandomState(seed)
    # decode-heavy grid: many users, short prompts, generations dominate
    grid = [(batch_size, 24), (batch_size + 2, 16)]
    max_prompt = 16  # prompt lengths drawn from [8, max_prompt]
    # byte budget = pages for ~2 in-flight WORST-CASE requests at fp32: the
    # fp32 arm is page-starved (the premise of the A/B), the int8 arm gets
    # the same bytes' worth of pages
    footprint = -(-(max_prompt + max(mt for _, mt in grid)) // page_size)
    fp32_pages = 2 * footprint
    budget_bytes = fp32_pages * kv_page_bytes(cfg, page_size, "float32")
    int8_pages = budget_bytes // max(
        kv_page_bytes(cfg, page_size, "int8"), 1)

    def run(kv_dtype, n_pages, prompts, max_tokens):
        eng = ServeEngine(params, cfg, batch_size=batch_size,
                          cache_len=cache_len, page_size=page_size,
                          prefill_chunk=16, token_budget=max(32, batch_size),
                          prefix_cache=False, max_pages=n_pages,
                          kv_dtype=kv_dtype, device=params.device)
        if warm:  # captured steps are per engine instance: warm THIS one
            _run(eng, prompts, max_tokens)
        skip = len(eng.token_log)
        tps, results = _run(eng, prompts, max_tokens)
        return eng, tps, results, skip

    points = []
    for n_users, max_tokens in grid:
        prompts = [rng.randint(0, cfg.vocab_size, int(L))
                   for L in rng.randint(8, max_prompt + 1, size=n_users)]
        point = {"users": n_users, "max_tokens": max_tokens}
        outs = {}
        for kvd, n_pages in (("float32", fp32_pages), ("int8", int8_pages)):
            eng, tps, results, skip = run(kvd, n_pages, prompts, max_tokens)
            outs[kvd] = [tok for u in sorted(results) for tok in results[u]]
            point[kvd if kvd == "int8" else "fp32"] = {
                "tokens_per_s": tps,
                "p50_decode_gap_ms": _p50_token_gap_ms(eng, skip=skip),
                "max_resident_pages": eng.n_pages,
                "pages_in_use_peak": eng.stats["pages_in_use_peak"],
                "kv_bytes_per_token": eng.stats["kv_bytes_per_token"],
                "kv_pool_bytes": eng.stats["kv_pool_bytes"],
            }
        n_match = sum(a == b for a, b in zip(outs["float32"], outs["int8"]))
        point["top1_agreement"] = n_match / max(len(outs["float32"]), 1)
        point["speedup"] = (point["int8"]["tokens_per_s"]
                            / point["fp32"]["tokens_per_s"])
        points.append(point)

    # warm-path identity on the int8 pool: a prefix hit maps cached int8
    # pages + scale rows into the new slot — byte-identical replay of the
    # cold path (quantize-at-write), so outputs must match exactly
    shared = rng.randint(0, cfg.vocab_size, 4 * page_size)
    warm_prompts = [np.concatenate([shared, rng.randint(0, cfg.vocab_size, 5)])
                    for _ in range(2)]
    eng = ServeEngine(params, cfg, batch_size=2, cache_len=cache_len,
                      page_size=page_size, prefill_chunk=16, token_budget=32,
                      kv_dtype="int8", device=params.device)
    u_cold = [eng.submit(p, max_tokens=4) for p in warm_prompts]
    cold = eng.run()
    u_warm = [eng.submit(p, max_tokens=4) for p in warm_prompts]
    warm_r = eng.run()
    prefix = {
        "prefix_hits": eng.stats["prefix_hits"],
        "tokens_reused": eng.stats["prefix_tokens_reused"],
        "warm_identical": ([cold[u] for u in u_cold]
                           == [warm_r[u] for u in u_warm]),
    }
    return {
        "byte_budget": int(budget_bytes),
        "pages": {"float32": int(fp32_pages), "int8": int(int8_pages)},
        "points": points,
        "min_top1_agreement": min(p["top1_agreement"] for p in points),
        "prefix_int8": prefix,
    }


def seed_params(arch: str, device=None):
    """(smoke config, its seed-0 random weights on the resolved device):
    the sweep's model, as the JAX sweep builds it from ``PRNGKey(0)``."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                           device=dev)
    return cfg, params


def sweep(arch: str, users, page_sizes, max_tokens: int, cache_len: int,
          baseline: bool = True, warm: bool = True, device=None):
    cfg, params = seed_params(arch, device)
    rows = []
    for n_users in users:
        prompts = _traffic(cfg, n_users, cache_len - max_tokens, max_tokens)
        batch = min(n_users, 8)
        ref_tps = None
        if baseline:
            ref = ReferenceEngine(params, cfg, batch_size=batch,
                                  cache_len=cache_len, device=params.device)
            if warm:  # steps are built per engine instance: warm then re-time
                _run(ref, prompts, max_tokens)
            ref_tps, _ = _run(ref, prompts, max_tokens)
            rows.append((f"serve/{arch}/seed/users={n_users}", ref_tps, ""))
        for ps in page_sizes:
            mean_ctx = int(np.mean([len(p) for p in prompts]) + max_tokens)
            # the bound's blend mirrors what the engine can actually pack in
            # one tick: batch decode tokens + prefill up to the 128 budget
            bound = mixed_bound(cfg, n_decode=batch,
                                n_prefill=min(32 * batch, 128 - batch),
                                context_len=mean_ctx,
                                page_size=ps)["tokens_per_s"]
            tps = {}
            for mode in ("chunked", "ragged"):
                eng_kw = dict(batch_size=batch, cache_len=cache_len,
                              page_size=ps, prefill_chunk=32,
                              token_budget=128, ragged=(mode == "ragged"))
                eng_kw["device"] = params.device
                if warm:  # build the steps outside the timed run
                    _run(ServeEngine(params, cfg, **eng_kw), prompts,
                         max_tokens)
                tps[mode], _ = _run(ServeEngine(params, cfg, **eng_kw),
                                    prompts, max_tokens)
            derived = (f"{tps['chunked'] / ref_tps:.1f}x-over-seed"
                       if ref_tps else "")
            rows.append((f"serve/{arch}/chunked/users={n_users}/page={ps}",
                         tps["chunked"], derived))
            derived = f"{tps['ragged'] / tps['chunked']:.2f}x-over-chunked"
            if ref_tps:
                derived += f",{tps['ragged'] / ref_tps:.1f}x-over-seed"
            derived += f",{tps['ragged'] / bound:.2e}-of-bound"
            rows.append((f"serve/{arch}/ragged/users={n_users}/page={ps}",
                         tps["ragged"], derived))
    lat = latency_scenario(cfg, params, cache_len=max(cache_len, 256),
                           warm=warm)
    for mode in ("chunked", "ragged"):
        rows.append((f"serve/{arch}/latency/{mode}",
                     lat[mode]["tokens_per_s"],
                     f"p50_decode_ms={lat[mode]['p50_decode_ms_under_prefill']:.1f}"))
    ratio = (lat["chunked"]["p50_decode_ms_under_prefill"]
             / lat["ragged"]["p50_decode_ms_under_prefill"])
    rows.append((f"serve/{arch}/latency/p50-improvement", ratio,
                 "x-lower-p50-decode-under-prefill"))
    pre = prefix_scenario(cfg, params, cache_len=max(cache_len, 256))
    for mode in ("prefix-off", "prefix-on"):
        r = pre[mode]
        rows.append((f"serve/{arch}/prefix/{mode}", r["tokens_per_s"],
                     f"prefix_hit_rate={r['prefix_hit_rate']:.2f},"
                     f"tokens_reused={r['tokens_reused']}"))
    rows.append((f"serve/{arch}/prefix/speedup", pre["speedup"],
                 "x-over-no-sharing,token_identical="
                 + str(pre["token_identical"]).lower()))
    sched_ab = scheduler_ab_scenario(cfg, params,
                                     cache_len=max(cache_len, 256),
                                     warm=warm)
    for sched in ("fifo", "prefix-aware", "slo"):
        r = sched_ab[sched]
        rows.append((f"serve/{arch}/scheduler/{sched}", r["tokens_per_s"],
                     f"p50_interactive_ms={r['p50_interactive_ms']:.1f},"
                     f"reused={r['prefix_tokens_reused']},"
                     f"evictions={r['evictions']}"))
    rows.append((f"serve/{arch}/scheduler/prefix-aware-speedup",
                 sched_ab["prefix_aware_speedup"],
                 "x-over-fifo-tokens-per-s,token_identical="
                 + str(sched_ab["token_identical"]).lower()))
    rows.append((f"serve/{arch}/scheduler/slo-p50-ratio",
                 sched_ab["slo_p50_latency_ratio"],
                 "x-fifo-p50-interactive-latency"))
    tiered = tiered_kv_scenario(cfg, params, warm=warm)
    rows += _tiered_rows(arch, tiered)
    spec = speculative_scenario(cfg, params, warm=warm)
    rows += _spec_rows(arch, spec)
    kv_ab = kv_ab_scenario(cfg, params, warm=warm)
    for p in kv_ab["points"]:
        for arm in ("fp32", "int8"):
            rows.append((
                f"serve/{arch}/kv-ab/{arm}/users={p['users']}"
                f"/max_tokens={p['max_tokens']}",
                p[arm]["tokens_per_s"],
                f"pages={p[arm]['max_resident_pages']},"
                f"p50_decode_gap_ms={p[arm]['p50_decode_gap_ms']:.1f}"))
        rows.append((
            f"serve/{arch}/kv-ab/speedup/users={p['users']}"
            f"/max_tokens={p['max_tokens']}", p["speedup"],
            f"x-int8-over-fp32-at-equal-bytes,"
            f"top1_agreement={p['top1_agreement']:.3f}"))
    return rows, lat, pre, kv_ab, sched_ab, tiered, spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--users", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--page-sizes", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--cold", action="store_true",
                    help="include the steps' build (and, on a card, "
                         "capture) time in the measurement")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid (one user count, one page size)")
    ap.add_argument("--sharded", action="store_true",
                    help="also run the KV-head tensor-parallel scenario "
                         "(not ported yet: raises NotImplementedError)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="skip the single-device sweep; run only the "
                         "sharded scenario (implies --sharded; not ported "
                         "yet)")
    ap.add_argument("--tiered-only", action="store_true",
                    help="skip the main sweep; run only the tiered KV "
                         "cache A/B (drop-on-evict vs host-tier replay)")
    ap.add_argument("--spec-only", action="store_true",
                    help="skip the main sweep; run only the speculative "
                         "decoding A/B (spec-off vs spec-on on the "
                         "repetitive completion workload)")
    ap.add_argument("--preempt-only", action="store_true",
                    help="skip the main sweep; run only the preemption "
                         "A/B (preempt vs admission-stall under an "
                         "overload wave) plus the chaos sub-run")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write rows + latency results as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda; cpu "
                         "rehearses the sweep on the CPU)")
    args = ap.parse_args(argv)
    if args.sharded or args.sharded_only:
        raise NotImplementedError(
            "the tensor-parallel serving scenario (--sharded, --sharded-only) "
            "needs ServeEngine(mesh=), which is not ported yet: it comes with "
            "the multi-GPU slice of the PyTorch port (ROADMAP.md, Queue 1)")
    if args.smoke:
        args.users, args.page_sizes, args.max_tokens = [4], [8], 4
    rows, lat, pre, kv_ab, sched_ab, tiered, spec = (
        [], None, None, None, None, None, None)
    preemption = None
    if args.tiered_only:
        cfg, params = seed_params(args.arch, args.device)
        tiered = tiered_kv_scenario(cfg, params, warm=not args.cold)
        rows = _tiered_rows(args.arch, tiered)
    elif args.spec_only:
        cfg, params = seed_params(args.arch, args.device)
        spec = speculative_scenario(cfg, params, warm=not args.cold)
        rows = _spec_rows(args.arch, spec)
    elif args.preempt_only:
        cfg, params = seed_params(args.arch, args.device)
        preemption = preemption_scenario(cfg, params, warm=not args.cold)
        rows = _preempt_rows(args.arch, preemption)
    else:
        rows, lat, pre, kv_ab, sched_ab, tiered, spec = sweep(
            args.arch, args.users, args.page_sizes, args.max_tokens,
            args.cache_len, baseline=not args.no_baseline, warm=not args.cold,
            device=args.device)
    print("name,tokens_per_s,derived")
    for name, tps, derived in rows:
        print(f"{name},{tps:.1f},{derived}", flush=True)
    if args.json:
        from repro_torch.core.autotune import select_serve_defaults

        payload = {
            "arch": args.arch,
            "grid": {"users": args.users, "page_sizes": args.page_sizes,
                     "max_tokens": args.max_tokens,
                     "cache_len": args.cache_len},
            "rows": [{"name": n, "tokens_per_s": t, "derived": d}
                     for n, t, d in rows],
            "latency_under_concurrent_prefill": lat,
            "prefix_scenario": pre,
            "kv_dtype_ab": kv_ab,
            "scheduler_ab": sched_ab,
            "tiered_kv": tiered,
            "speculative": spec,
            "preemption": preemption,
            # host_pool_pages axis prices the tiered point's promotion
            # traffic against untiered re-prefill; the spec_ks axis prices
            # draft-token goodput on the repetitive decode point
            "tuned_serving_config": select_serve_defaults(
                args.arch, smoke=True, host_pool_pages=(0, 64),
                spec_ks=(0, 4))["best"],
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")


if __name__ == "__main__":
    main()
