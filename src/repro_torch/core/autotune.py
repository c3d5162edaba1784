"""Configuration autotuner for the port, priced on an H100: the systems
operator's role in the paper, automated.

A copy of the JAX package's ``core/autotune.py`` (the port imports nothing
of that package), both halves:

- training: pick {remat policy, attention path, query chunk} per (arch ×
  shape) by counting each candidate's rank-0 program on the production
  mesh (``launch.dryrun.lower_cell``) and comparing roofline terms
  (``core.roofline.roofline_terms`` on ``H100``).  The paper's conclusion
  ("set KMP_AFFINITY/taskset/all2all-cache once, system-wide, and every
  user's Nproc×Nthread choice stays near peak") maps to
  ``select_defaults``: sweep ``DEFAULT_CANDIDATES`` on the mesh, score by
  the dominant roofline term, and emit the winner.  Derived from counts,
  not measured.
- serving: ONE (token_budget, prefill_chunk, page_size, kv_dtype,
  scheduler) for all traffic, picked against the analytic roofline blend
  (``core.roofline.mixed_bound``): the paper's "set it once system-wide,
  every grid point stays near peak" claim at serving time.  Instead of
  per-workload retuning, the serving knobs are swept against
  ``mixed_bound`` over a traffic-mix grid (decode-heavy steady state, a
  chat/doc blend, a prefill burst -- each at a short-chat and a
  long-document context) and the config whose WORST grid point is the
  largest fraction of that point's achievable peak wins (max-min, not
  max-mean: the paper's figures reward flatness across the grid, not one
  tall corner).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.roofline import H100, HwSpec, mixed_bound, roofline_terms


@dataclass(frozen=True)
class Candidate:
    name: str
    overrides: Dict = field(default_factory=dict)  # ModelCfg.replace kwargs
    microbatches: Optional[int] = None


DEFAULT_CANDIDATES = (
    Candidate("baseline", {}),
    Candidate("remat-dots", {"remat": "dots"}),
    Candidate("remat-none", {"remat": "none"}),
    Candidate("flash-attn", {"use_flash": True}),
    Candidate("q-chunk-512", {"attn_q_chunk": 512}),
)


def evaluate(arch: str, shape_name: str, mesh, candidates=DEFAULT_CANDIDATES,
             hw: HwSpec = H100, hbm_limit: float = 80 * 2**30) -> List[Dict]:
    """Count every candidate's rank-0 program of the card on ``mesh``
    (``launch.dryrun.lower_cell``); return scored rows, ranked by
    step-time bound."""
    from repro_torch.launch.dryrun import lower_cell

    rows = []
    for cand in candidates:
        try:
            res = lower_cell(arch, shape_name, mesh, overrides=cand.overrides)
        except Exception as e:  # servelint: ignore[broad-except] — a sweep candidate may be invalid for this arch in arbitrary ways; the error is recorded in the row, never swallowed
            rows.append({"candidate": cand.name, "error": repr(e)[:200]})
            continue
        terms = roofline_terms(res, hw)
        rows.append({
            "candidate": cand.name,
            "fits_hbm": res["analytic_hbm_bytes"] <= hbm_limit * 0.9,
            "step_bound_s": terms["step_time_lower_bound_s"],
            "dominant": terms["dominant"],
            "roofline_fraction": terms["roofline_fraction"],
            **{k: terms[k] for k in ("compute_s", "memory_s", "collective_s")},
        })
    ok = [r for r in rows if r.get("fits_hbm")]
    # Candidate name is an explicit tie-break: float-equal step bounds (e.g.
    # two remat modes that count the same program) would otherwise rank in
    # insertion order.
    ranked = sorted(ok or [r for r in rows if "error" not in r],
                    key=lambda r: (r["step_bound_s"], r["candidate"]))
    for i, r in enumerate(ranked):
        r["rank"] = i
    return rows


def select_defaults(arch: str, shape_name: str, mesh, **kw) -> Dict:
    rows = evaluate(arch, shape_name, mesh, **kw)
    best = min((r for r in rows if "error" not in r),
               key=lambda r: (not r.get("fits_hbm", False), r["step_bound_s"],
                              r["candidate"]))
    return {"best": best, "table": rows}


# Analytic scheduler model for the two policy-sensitive traffic points the
# measured A/B (benchmarks/serve_sweep.py:scheduler_ab_scenario) exercises.
# ``residency``: fraction of a shared family prefix still resident when the
# NEXT family member is admitted, under the A/B's pressure regime (the pool
# holds roughly half the live prefix families at once): prefix-aware
# admission groups a family's requests back to back so its prefix survives
# its whole run; interleaving policies (fifo, slo) lose it to the other
# families' allocations about half the time.  ``interactive_wait``: document
# prefills an interactive arrival sits behind before admission — slo's
# class-ordered window admits it next (0); arrival-ordered policies make it
# wait out one queued document (1).
SCHEDULER_MODEL = {
    "fifo": {"residency": 0.5, "interactive_wait": 1.0},
    "prefix-aware": {"residency": 1.0, "interactive_wait": 1.0},
    "slo": {"residency": 0.5, "interactive_wait": 0.0},
    # the composite (SLO class first, family grouping within a class) keeps
    # prefix-aware's residency AND slo's interactive jump — it gives up
    # neither criterion, which under max-min is exactly what wins the axis
    "class-then-family": {"residency": 1.0, "interactive_wait": 0.0},
}


def select_serve_defaults(arch: str, *, batch_size: int = 8,
                          context_len: int = 256,
                          token_budgets=(64, 128, 256),
                          prefill_chunks=(16, 32, 64),
                          page_sizes=(8, 16, 32),
                          kv_dtypes=("float32", "bfloat16", "int8"),
                          schedulers=("fifo", "prefix-aware", "slo",
                                      "class-then-family"),
                          device_counts=(1,),
                          host_pool_pages=(0,),
                          spec_ks=(0,), spec_accept_rate: float = 0.6,
                          shared_frac: float = 0.75, gen_tokens: int = 32,
                          hw: HwSpec = H100, smoke: bool = False) -> Dict:
    """Emit ONE tuned serving config for ``serve.ServeEngine``.

    Scores every (token_budget × prefill_chunk × page_size × kv_dtype ×
    scheduler) candidate on a traffic-mix grid via ``roofline.mixed_bound``
    (the parameter sweep is analytic — no engine runs).  The ``kv_dtype``
    axis makes the tuned config pick the MEMORY REPRESENTATION — the
    paper's "set it once" covers the decisive memory-mode knob: an int8
    pool streams roughly a quarter of the fp32 decode-side bytes, so on
    memory-dominated mixes it lifts every criterion at once.  The
    ``scheduler`` axis adds the WORKLOAD POLICY via ``SCHEDULER_MODEL``,
    scored on two extra criteria that mirror the measured A/B scenario:

    - ``warm@families`` — request throughput on shared-prefix traffic
      (``shared_frac`` of each ``context_len`` prompt is a family prefix,
      ``gen_tokens`` generated): serving a request costs
      ``(1 - hit)·S + G`` pack tokens where ``hit = shared_frac ×
      residency(scheduler)``, so policies that keep a family's prefix
      resident convert the same pack rate into more emitted tokens.
    - ``interactive@arrival`` — 1 / (time to an interactive arrival's first
      token): ``interactive_wait(scheduler)`` document prefills of
      admission delay plus one tick, at the blend point's tick time.

    The remaining criteria are pack tokens/s on the mix points (prefill
    capped at what the engine can actually pack per tick) PLUS the decode
    rate under the blend tick (1/tick_s — a decoding user's inter-token gap
    is the tick, so this criterion pulls against unbounded pack growth).
    Returns::

        {"best": {token_budget, prefill_chunk, page_size, kv_dtype,
                  scheduler, score, ...},
         "table": [per-candidate rows with per-criterion values/fractions]}

    ``score`` is the candidate's worst-case fraction of the per-criterion
    best across all candidates (1.0 = this config is on the peak for every
    criterion) — under max-min the scheduler axis is typically decided by
    whichever criterion a policy sacrifices LEAST (slo gives up some warm
    throughput, prefix-aware gives up the interactive jump; fifo gives up
    both and can never win the axis).  ``benchmarks/serve_sweep.py``
    records the selection next to the measured rows in its ``--json``
    payload (``tuned_serving_config``).

    ``device_counts`` adds the KV-head tensor-parallel axis (ServeEngine
    ``mesh=``, not ported yet): each count is threaded to
    ``mixed_bound(n_devices=...)``, which divides the paged-layer attention
    FLOPs and KV byte terms but not the replicated parameter sweep — so
    the tuner sees exactly where TP stops paying (once the per-device
    bound goes param-dominated).  The
    default ``(1,)`` keeps the single-device grid (and table size)
    unchanged; rows and ``best`` carry ``n_devices`` either way.

    ``host_pool_pages`` adds the TIERED-CACHE axis (ServeEngine
    ``host_pages=``).  When a nonzero size is on the axis, every candidate
    is additionally scored on ``spill@replay``: warm-replay traffic whose
    prefix working set exceeds the device pool (the tiered bench scenario).
    Untiered (0), a spilled prefix re-prefills — the slot is occupied for
    ``ceil(S / chunk)`` prefill ticks (per-slot chunk rate, capped by the
    leftover budget split across the replaying slots — the engine's pack
    bound) before its ``G`` decode ticks; tiered, it PROMOTES —
    ``S/page_size`` pages of host→device traffic priced by
    ``mixed_bound(promoted_pages=...)`` against ``hw.h2d_bw``, overlapped
    with decode, so the request costs only its ``G`` decode ticks at the
    (possibly promotion-roofed) tick time.  The default ``(0,)`` skips the
    criterion entirely: the existing selection is bit-identical.

    ``spec_ks`` adds the SPECULATIVE-DECODING axis (ServeEngine
    ``spec_k=`` / ``serve.scheduler.SpeculativeScheduler``).  When a
    nonzero k is on the axis, every candidate is additionally scored on
    ``spec@repetitive``: accepted-token goodput on repetitive decode-heavy
    traffic (the prompt-lookup drafter's home turf), priced by
    ``mixed_bound(draft_tokens=, accept_rate=spec_accept_rate)`` — draft
    rows pay compute and KV writes but share the slot's KV page-stream, so
    on memory-dominated ticks acceptance is nearly free throughput.  The
    effective k is capped by the leftover budget per decoding slot
    (``(token_budget - batch) // batch`` — the engine packs drafts strictly
    after decode and prefill), so the axis pulls TOWARD bigger budgets in a
    way the other criteria must balance.  The default ``(0,)`` skips the
    criterion entirely: the existing selection is bit-identical.
    """
    cfg = get_config(arch, smoke=smoke)
    chat_ctx = max(context_len // 4, 1)

    def mix_points(budget, chunk):
        # prefill per tick is bounded by BOTH the leftover budget and the
        # per-slot chunk cap times the slot count — the engine can never
        # pack more (see ServeEngine._ragged_tick), so crediting a candidate
        # with an unpackable burst would make big budgets win for free
        dec = min(batch_size, budget)
        packable = chunk * batch_size
        blend = min(packable, max(budget - dec, 0))
        burst = min(packable, budget - 1)
        return (("decode@doc", dec, 0, context_len),
                ("decode@chat", dec, 0, chat_ctx),
                ("blend@doc", dec, blend, context_len),
                ("burst@chat", 1, burst, chat_ctx))

    rows: List[Dict] = []
    for tb in token_budgets:
        if tb < batch_size:
            continue  # engine invariant: every decoding slot packs per tick
        for pc in prefill_chunks:
            if pc >= tb:
                continue  # a chunk that fills the whole budget starves decode
            for ps in page_sizes:
                for kvd, ndev in ((kvd, ndev) for kvd in kv_dtypes
                                  for ndev in device_counts):
                    tps = {}
                    blend_tick_s = 1e-30
                    blend_tps = 0.0
                    for name, nd, npf, ctx in mix_points(tb, pc):
                        r = mixed_bound(cfg, n_decode=nd, n_prefill=npf,
                                        context_len=ctx, hw=hw, page_size=ps,
                                        kv_dtype=kvd, n_devices=ndev)
                        tps[name] = r["tokens_per_s"]
                        if name == "blend@doc":
                            blend_tick_s = max(r["tick_s"], 1e-30)
                            blend_tps = r["tokens_per_s"]
                            # a decoding user's inter-token gap IS the tick:
                            # the latency criterion pulls AGAINST ever-bigger
                            # packs, so max-min trades throughput off against
                            # p50 decode latency under concurrent prefill
                            tps["decode_rate@blend"] = 1.0 / blend_tick_s
                    # tiered-cache axis: replay throughput when the prefix
                    # working set spills past the device pool.  Scheduler-
                    # independent, so computed once per (knobs, host size).
                    S = max(int(context_len * shared_frac), 1)
                    G = max(gen_tokens, 1)
                    tier_on = any(h > 0 for h in host_pool_pages)
                    spill = {}
                    for h in host_pool_pages:
                        if not tier_on:
                            continue
                        dec = min(batch_size, tb)
                        if h > 0:
                            # each replayed request promotes its S/ps spilled
                            # pages once over its G decode ticks, overlapped
                            rp = mixed_bound(
                                cfg, n_decode=dec, n_prefill=0,
                                context_len=context_len, hw=hw, page_size=ps,
                                kv_dtype=kvd, n_devices=ndev,
                                promoted_pages=dec * max(S // ps, 1) / G)
                            spill[h] = dec / (G * max(rp["tick_s"], 1e-30))
                        else:
                            # both tiers miss: before its G decode ticks the
                            # slot re-prefills its spilled prefix at the
                            # per-slot chunk rate (the leftover budget split
                            # across the replaying slots caps the chunk —
                            # exactly the engine's pack bound)
                            chunk_eff = max(
                                min(pc, max(tb - dec, 0) // max(dec, 1)), 1)
                            prefill_ticks = -(-S // chunk_eff)
                            spill[h] = dec / ((prefill_ticks + G)
                                              * blend_tick_s)
                    # speculative axis: accepted-token goodput on repetitive
                    # decode-heavy traffic.  Scheduler-independent (the
                    # drafter rides on top of any ordering policy), so
                    # computed once per (knobs, k).
                    spec_on = any(k > 0 for k in spec_ks)
                    spec = {}
                    for sk in spec_ks:
                        if not spec_on:
                            continue
                        dec = min(batch_size, tb)
                        # drafts pack only in the budget left after every
                        # decoding slot's base token — the engine's strict
                        # decode-first priority caps k per slot
                        k_eff = min(int(sk), max(tb - dec, 0) // max(dec, 1))
                        rs = mixed_bound(
                            cfg, n_decode=dec, n_prefill=0,
                            context_len=context_len, hw=hw, page_size=ps,
                            kv_dtype=kvd, n_devices=ndev,
                            draft_tokens=float(k_eff),
                            accept_rate=spec_accept_rate if k_eff else 0.0)
                        spec[sk] = rs["tokens_per_s"]
                    for sched, h, sk in ((s, h, sk) for s in schedulers
                                         for h in host_pool_pages
                                         for sk in spec_ks):
                        model = SCHEDULER_MODEL[sched]
                        hit = shared_frac * model["residency"]
                        # pack tokens a warm-family request still costs vs
                        # the full cold S+G — the scheduler's reuse leverage
                        crit = dict(tps)
                        crit["warm@families"] = (
                            blend_tps * (S + G) / ((1.0 - hit) * S + G))
                        # ONE document occupies one slot and prefills at
                        # most prefill_chunk tokens per tick (the leftover
                        # budget caps it too) — not chunk x batch_size
                        prefill_ticks = -(-context_len // max(
                            min(pc, tb - 1), 1))
                        crit["interactive@arrival"] = 1.0 / (
                            blend_tick_s
                            * (1 + model["interactive_wait"] * prefill_ticks))
                        if tier_on:
                            crit["spill@replay"] = spill[h]
                        if spec_on:
                            crit["spec@repetitive"] = spec[sk]
                        rows.append({"token_budget": tb, "prefill_chunk": pc,
                                     "page_size": ps, "kv_dtype": kvd,
                                     "scheduler": sched, "n_devices": ndev,
                                     "host_pool_pages": h, "spec_k": sk,
                                     "criteria": crit})
    if not rows:
        raise ValueError("no valid (token_budget, prefill_chunk, page_size, "
                         "kv_dtype, scheduler) candidate for the given grids")
    peak = {name: max(r["criteria"][name] for r in rows)
            for name in rows[0]["criteria"]}
    for r in rows:
        frac = {name: r["criteria"][name] / max(peak[name], 1e-30)
                for name in r["criteria"]}
        r["fraction_of_peak"] = frac
        r["score"] = min(frac.values())
        r["mean_fraction"] = sum(frac.values()) / len(frac)
    best = max(rows, key=lambda r: (r["score"], r["mean_fraction"]))
    return {"best": {k: best[k] for k in ("token_budget", "prefill_chunk",
                                          "page_size", "kv_dtype",
                                          "scheduler", "n_devices",
                                          "host_pool_pages", "spec_k",
                                          "score", "mean_fraction")},
            "table": rows}
