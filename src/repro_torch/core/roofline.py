"""Three-term roofline model over per-device cost rows, priced for an
NVIDIA H100.

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = HBM_bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / link_bw

A copy of the JAX package's ``core/roofline.py`` (the port imports nothing
of that package) with the same ``HwSpec`` fields, so either package's spec
can be built from the other's ``dataclasses.asdict``; its one instance here
is ``H100`` (SXM5, 80 GB), the default of every function.  The analytic
serving bounds (``decode_bound``, ``mixed_bound``) are what the serving
autotuner (``core/autotune.py``) and the serving sweep
(``benchmarks/serve_sweep.py``) score against.  ``roofline_terms`` and
``format_row`` take a dry-run row (``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``, ``n_devices``,
``arch``, ``shape``, ``mesh``); the port has no producer of such rows yet
(ROADMAP.md, Queue 1, multi-GPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs import (SHAPES_BY_NAME, active_param_count,
                                 get_config, param_count)


@dataclass(frozen=True)
class HwSpec:
    name: str = "h100-sxm5-80gb"
    # dense bf16 tensor-core FLOP/s (NVIDIA H100 data sheet, SXM5: 989.4
    # TFLOPS bf16 without sparsity)
    peak_flops: float = 989e12
    # HBM3 bytes/s (NVIDIA H100 data sheet, SXM5: 3.35 TB/s)
    hbm_bw: float = 3.35e12
    # NVLink 4 bytes/s each direction (NVIDIA H100 data sheet: 900 GB/s
    # bidirectional)
    ici_bw: float = 450e9
    # host->device promotion bytes/s: PCIe 5.0 x16, each direction (64 GB/s;
    # NVIDIA H100 data sheet, PCIe Gen5 128 GB/s bidirectional) -- the
    # governing term of the tiered KV cache, as the Xeon Phi studies
    # measured the DDR->MCDRAM path to be the governing term of cache mode
    h2d_bw: float = 64e9


H100 = HwSpec()


def roofline_terms(result: Dict, hw: HwSpec = H100, cfg=None,
                   microbatches=None) -> Dict:
    """``result`` is one dry-run row: the per-device FLOPs, bytes and
    collective bytes of one (arch x shape x mesh) cell, with the keys of
    the JAX package's ``launch/dryrun.lower_cell`` rows (``hlo_*`` names
    included, so rows cross between the packages).

    The memory term is the ANALYTIC HBM-traffic model (core/memory_model);
    the row's own byte count is still reported as ``memory_s_hlo_proxy``
    for comparison.
    """
    from repro_torch.core import memory_model

    cfg0 = cfg if cfg is not None else get_config(result["arch"])
    shape0 = SHAPES_BY_NAME[result["shape"]]
    mesh_dims = [int(x) for x in result["mesh"].split("x")]
    mesh_shape = dict(zip(("pod", "data", "model")[-len(mesh_dims):], mesh_dims))
    mb = microbatches if microbatches is not None else (
        8 if param_count(cfg0) > 50e9 and shape0.kind == "train" else 1)
    analytic_bytes = memory_model.analytic_traffic(cfg0, shape0, mesh_shape, mb)

    t_comp = result["flops_per_device"] / hw.peak_flops
    t_mem = analytic_bytes / hw.hbm_bw
    t_coll = result["collective_bytes_per_device"] / hw.ici_bw
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    total = max(t_comp + t_mem + t_coll, 1e-30)

    # useful model FLOPs: 6·N·D train (fwd+bwd), 2·N·D forward-only;
    # D = tokens processed by the step
    n_active = active_param_count(cfg0)
    shape = shape0
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        model_flops = 2 * n_active * tokens

    hlo_flops_global = result["flops_per_device"] * result["n_devices"]
    useful_ratio = model_flops / max(hlo_flops_global, 1.0)
    # fraction of the compute roofline actually achieved if the step ran at
    # the dominant-term time (the paper's "66% of practical peak" analogue)
    ideal_t = model_flops / (result["n_devices"] * hw.peak_flops)
    roofline_frac = ideal_t / max(terms[dom], 1e-30)

    return {
        **terms,
        "memory_s_hlo_proxy": result["bytes_per_device"] / hw.hbm_bw,
        "dominant": dom,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_flop_ratio": useful_ratio,
        "roofline_fraction": min(roofline_frac, 1.0),
        "step_time_lower_bound_s": terms[dom],
        "compute_fraction_of_total": t_comp / total,
    }


# the single source of truth for KV-pool storage costs (serve.pool prices
# pages, and serve.engine sizes its byte-denominated page budget, from these
# same tables)
KV_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
# int8 pools carry one float32 scale per pool entry per KV head
KV_SCALE_BYTES = {"float32": 0, "bfloat16": 0, "int8": 4}


def _kv_elem_bytes(kv_dtype, head_dim: int, act_bytes: float) -> float:
    """Bytes one stored KV element costs under a pool representation,
    including the amortized per-entry-per-head scale of int8 pools
    (KV_SCALE_BYTES spread over ``head_dim`` elements).  ``kv_dtype=None``
    follows the activation dtype — the unquantized pool."""
    if kv_dtype is None:
        return act_bytes
    kvd = str(kv_dtype)
    return KV_ITEMSIZE[kvd] + KV_SCALE_BYTES[kvd] / head_dim


def decode_bound(cfg, batch: int, context_len: int, hw: HwSpec = H100,
                 page_size: int = None, kv_dtype=None,
                 n_devices: int = 1) -> Dict:
    """Analytic tokens/s upper bound for one batched decode tick.

    The serving-engine analogue of the paper's practical-peak line: a decode
    step reads every active parameter plus each attention layer's live KV,
    and computes 2·N_active FLOPs per token plus the attention dot-products.
    ``page_size`` models the paged cache's read granularity (a slot's KV
    traffic rounds up to whole pages); windowed layers clamp their context
    to the window.  ``kv_dtype`` (None | "float32" | "bfloat16" | "int8")
    makes the KV-byte term representation-aware: an int8 pool streams
    ``1 + 4/hd`` bytes per element (values + amortized scales) instead of
    the activation dtype's 2-4 — the decode side of serving is memory-bound
    (the KNL follow-up's regime), so this term is usually the bound.
    benchmarks/serve_sweep.py scores measured engine throughput against
    ``tokens_per_s`` from this bound.

    ``n_devices`` models KV-head tensor parallelism (``ServeEngine(mesh=)``,
    not ported yet: ROADMAP.md, Queue 1, multi-GPU):
    each device holds 1/N of the paged KV pools and attends over only its
    head slice, so the attention FLOPs and KV byte terms divide by N.  The
    parameter sweep does NOT divide — serving TP replicates the weights
    (the KV pool, not the params, is what outgrows one device) — which is
    why decode throughput scales sub-linearly and saturates once the
    per-device bound goes param-sweep-dominated.
    """
    n_act = active_param_count(cfg)
    param_bytes = n_act * (2 if cfg.param_dtype == "bfloat16" else 4)
    act_bytes = 2 if cfg.dtype == "bfloat16" else 4

    flops = 2.0 * n_act * batch
    kv_bytes = 0.0
    for st in cfg.stages:
        for blk in st.pattern:
            if blk.mixer not in ("attn", "cross_attn") or blk.attn is None:
                continue
            a = blk.attn
            t_eff = context_len if a.window is None else min(a.window,
                                                             context_len)
            eb = act_bytes
            if a.window is None:
                # only global layers page (and quantize); windowed layers
                # keep dense activation-dtype per-slot circular buffers
                # (see attention.init_paged_cache)
                if page_size:
                    t_eff = -(-t_eff // page_size) * page_size
                eb = _kv_elem_bytes(kv_dtype, a.head_dim, act_bytes)
            # per-device KV-head shard count: only global (paged) layers
            # shard, and only when the head count divides
            shards = (n_devices if a.window is None
                      and a.num_kv_heads % n_devices == 0 else 1)
            # qk^T + pv per query token, grouped heads
            flops += (st.repeats * 4.0 * batch * t_eff * a.num_heads
                      * a.head_dim / shards)
            kv_bytes += (st.repeats * 2.0 * batch * t_eff * a.num_kv_heads
                         * a.head_dim * eb / shards)

    t_comp = flops / hw.peak_flops
    t_mem = (param_bytes + kv_bytes) / hw.hbm_bw
    t = max(t_comp, t_mem, 1e-30)
    return {
        "compute_s": t_comp,
        "memory_s": t_mem,
        "dominant": "compute" if t_comp >= t_mem else "memory",
        "kv_bytes": kv_bytes,
        "param_bytes": param_bytes,
        "tokens_per_s": batch / t,
    }


def mixed_bound(cfg, n_decode: int, n_prefill: int, context_len: int,
                hw: HwSpec = H100, page_size: int = None,
                kv_dtype=None, n_devices: int = 1,
                promoted_pages: float = 0.0,
                draft_tokens: float = 0.0,
                accept_rate: float = 0.0,
                swapped_pages: float = 0.0) -> Dict:
    """Analytic bound for ONE ragged tick — the decode/prefill roofline blend.

    Scores a pack of ``n_decode`` decode tokens + ``n_prefill`` prefill-chunk
    tokens against the hardware roofline.  The active parameters are swept
    ONCE per tick regardless of the mix — that is the ragged engine's
    structural win: the two-phase engine serves the same mix with a prefill
    tick AND a decode tick, paying the parameter sweep (the memory-bound
    term that dominates small-batch serving) twice.  Decode tokens read
    their slot's full live KV (page-rounded, like ``decode_bound``); prefill
    tokens attend over ~half the context on average and add their own KV
    writes.

    ``kv_dtype`` makes the paged-pool byte terms representation-aware (see
    ``decode_bound``): int8 streams ``1 + 4/hd`` bytes per stored element —
    values plus amortized scales — on BOTH the decode-side reads and the
    write side, which is what moves a memory-dominated tick's bound.

    Returns per-tick terms, byte terms (``kv_read_bytes`` /
    ``kv_write_bytes`` — the decode-side traffic the int8 pool halves or
    better), ``tokens_per_s`` for the whole pack, and
    ``speedup_vs_two_phase`` — the bound-level ratio against running the
    same tokens as separate prefill + decode programs.  The serve sweep
    reports measured ragged throughput against this bound.

    ``n_devices`` models KV-head tensor parallelism exactly as in
    ``decode_bound``: paged-layer attention FLOPs and KV read/write bytes
    divide by N (when the layer's KV-head count divides), the replicated
    parameter sweep does not.

    ``promoted_pages`` prices the TIERED KV cache's host→device traffic:
    the average pool pages per tick promoted from the host tier on prefix
    hits (``ServeEngine(host_pages=...)``).  Promotion bytes cross the
    ``hw.h2d_bw`` link — the governing term of the paper's cache mode —
    but the copy is issued at admission and OVERLAPPED with the tick's
    compute, so the tick time is ``max(compute, memory, promotion)``, not
    a sum: tiering is free until H2D traffic becomes the binding roof
    (reported as ``promotion_s`` / ``promoted_bytes``).  The alternative
    the term is priced against is re-prefilling the same tokens, which
    pays compute AND pool writes — a host hit wins whenever
    ``promotion_s`` is below the re-prefill tick it replaces.

    ``swapped_pages`` prices PREEMPTION swap traffic the same way: the
    average pool pages per tick moving across the host link for slot
    preemption — parks (device→host demote gathers of a victim's private
    pages) plus unparks (host→device promote scatters at resume).  Swap
    bytes are identical to promotion bytes per page and cross the same
    ``hw.h2d_bw`` link, overlapped with the tick's compute just like
    promotions (the gather is issued at preemption, the scatter at
    re-admission), so they fold into the SAME third roof:
    ``max(compute, memory, promotion + swap)``.  What preemption buys
    against that cost: the stall arm pays the victim's pages sitting idle
    under head-of-line blocking; the preempt arm pays one park + one
    unpark per victim — goodput wins whenever the blocked requests'
    tokens outweigh the swap roof (the ``preemption_scenario`` A/B
    measures exactly this).

    ``draft_tokens`` / ``accept_rate`` price SPECULATIVE decoding
    (``ServeEngine(spec_k=...)``): ``draft_tokens`` verify tokens ride
    along per decoding slot, of which ``accept_rate`` are expected to be
    accepted.  The asymmetry this model exists to show: a verify token
    pays full compute (a query over the slot's whole context, plus its
    share of the parameter matmuls) and writes its KV row, but adds
    NOTHING to the KV read side — the slot's page-stream is already being
    read for its base decode token, and the verify rows share it.  Since
    small-batch decode ticks are memory-bound on exactly that page-stream
    (plus the parameter sweep), verify tokens are near-free until the
    added compute reaches the memory roof — which is why the bound's
    ``tokens_per_s`` (EMITTED tokens: ``n_decode · (1 + accept_rate ·
    draft_tokens) + n_prefill`` per tick) grows almost linearly in the
    accepted depth.  Defaults (0, 0) reproduce the non-speculative bound
    bit for bit.
    """
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1], got {accept_rate}")
    if draft_tokens < 0:
        raise ValueError(f"draft_tokens must be >= 0, got {draft_tokens}")
    n_act = active_param_count(cfg)
    param_bytes = n_act * (2 if cfg.param_dtype == "bfloat16" else 4)
    act_bytes = 2 if cfg.dtype == "bfloat16" else 4
    total = (n_decode * (1.0 + accept_rate * draft_tokens)) + n_prefill

    def _tick(n_dec, n_pre, n_draft=0.0):
        toks = n_dec + n_pre + n_draft
        flops = 2.0 * n_act * toks
        kv_read = kv_write = 0.0
        for st in cfg.stages:
            for blk in st.pattern:
                if blk.mixer not in ("attn", "cross_attn") or blk.attn is None:
                    continue
                a = blk.attn
                t_eff = (context_len if a.window is None
                         else min(a.window, context_len))
                eb = act_bytes
                if a.window is None:
                    if page_size:
                        t_eff = -(-t_eff // page_size) * page_size
                    eb = _kv_elem_bytes(kv_dtype, a.head_dim, act_bytes)
                shards = (n_devices if a.window is None
                          and a.num_kv_heads % n_devices == 0 else 1)
                # decode AND draft tokens see the whole context; prefill
                # tokens see ~half of it on average (causal positions
                # 0..ctx).  COMPUTE scales with every query token...
                q_ctx = (n_dec + n_draft) * t_eff + n_pre * t_eff / 2.0
                # ...but the KV READ stream does not scale with drafts:
                # verify rows share the page-stream their slot's base
                # decode token already reads (the near-free-verify claim)
                q_ctx_read = n_dec * t_eff + n_pre * t_eff / 2.0
                flops += (st.repeats * 4.0 * q_ctx * a.num_heads
                          * a.head_dim / shards)
                kv_read += (st.repeats * 2.0 * q_ctx_read * a.num_kv_heads
                            * a.head_dim * eb / shards)
                kv_write += (st.repeats * 2.0 * toks * a.num_kv_heads
                             * a.head_dim * eb / shards)
        t_comp = flops / hw.peak_flops
        t_mem = (param_bytes + kv_read + kv_write) / hw.hbm_bw
        return t_comp, t_mem, max(t_comp, t_mem, 1e-30), kv_read, kv_write

    t_comp, t_mem, t, kv_read, kv_write = _tick(
        n_decode, n_prefill, n_decode * draft_tokens)
    # promotion term: pages/tick crossing the host->device link, overlapped
    # with the tick's compute (issued at admission) — a third roof, not an
    # added cost
    page_bytes = 0.0
    if promoted_pages or swapped_pages:
        ps = page_size or 1
        for st in cfg.stages:
            for blk in st.pattern:
                if (blk.mixer not in ("attn", "cross_attn")
                        or blk.attn is None or blk.attn.window is not None):
                    continue
                a = blk.attn
                eb = _kv_elem_bytes(kv_dtype, a.head_dim, act_bytes)
                shards = n_devices if a.num_kv_heads % n_devices == 0 else 1
                page_bytes += (st.repeats * 2.0 * ps * a.num_kv_heads
                               * a.head_dim * eb / shards)
    promo_bytes = page_bytes * promoted_pages
    # preemption swap bytes are priced per page exactly like promotion
    # (same layers, same dtype, same link) and share its overlap roof
    swap_bytes = page_bytes * swapped_pages
    t_promo = (promo_bytes + swap_bytes) / hw.h2d_bw
    t = max(t, t_promo, 1e-30)
    # two-phase floor: the same tokens as a decode-only tick plus a
    # prefill-only tick, each paying its own parameter sweep
    t_dec = _tick(n_decode, 0)[2]
    t_pre = _tick(0, n_prefill)[2]
    two_phase = ((t_dec if n_decode else 0.0) + (t_pre if n_prefill else 0.0)
                 or 1e-30)
    dom = "compute" if t_comp >= t_mem else "memory"
    return {
        "compute_s": t_comp,
        "memory_s": t_mem,
        "promotion_s": t_promo,
        "promoted_bytes": promo_bytes,
        "swap_s": swap_bytes / hw.h2d_bw,
        "swapped_bytes": swap_bytes,
        "dominant": "promotion" if t_promo >= max(t_comp, t_mem) and t_promo
                    else dom,
        "kv_read_bytes": kv_read,
        "kv_write_bytes": kv_write,
        "tick_s": t,
        # EMITTED tokens per second: with speculation each decode slot
        # lands 1 + accept_rate·draft_tokens accepted tokens per tick
        "tokens_per_s": total / t if total else 0.0,
        "accepted_per_slot_tick": 1.0 + accept_rate * draft_tokens,
        "drafted_tokens": n_decode * draft_tokens,
        "speedup_vs_two_phase": two_phase / t,
    }


def format_row(result: Dict, terms: Dict) -> str:
    return (f"| {result['arch']} | {result['shape']} | {result['mesh']} "
            f"| {terms['compute_s']:.3e} | {terms['memory_s']:.3e} "
            f"| {terms['collective_s']:.3e} | {terms['dominant'].replace('_s','')} "
            f"| {terms['useful_flop_ratio']:.2f} | {terms['roofline_fraction']:.1%} |")
