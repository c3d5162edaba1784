"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (every check asserts; any failure exits non-zero):

1. Card, power limit, torch/CUDA versions; TF32 off for matmul and cuDNN.
2. Build the CUDA kernels of the serving and training paths from
   ``src/repro_torch``, one ``nvcc`` per source started together, and print
   ptxas's register and shared-memory report.
3. Each kernel against its plain PyTorch version at full-width shapes.
   Tolerance: f32 outputs rtol = atol = 1e-4; bf16 outputs atol = 2e-2,
   compared in f32, and for flash_attention also each output row within
   1e-2 of its norm.
   - ragged_paged_flash (qwen2-1.5b: kvH 2, G 6, hd 128; page 16;
     cache_len 2048; a 256-token mixed pack of decode and prefill tokens
     from 8 slots, with unmapped (sentinel) pages and lens == 0 rows), for
     q in {f32, bf16} x pools in {f32, bf16, int8}; then CUDA-event times
     of the kernel and the plain version at a steady decode tick and a
     mixed tick, beside the byte/operation bound.
   - flash_attention at the training shape (q (24, 4096, 128) over k/v
     (4, 4096, 128): batch 2 x 2 KV heads x 6 query heads each) in f32 and
     bf16, windowed (window 512, bf16), and a small odd case (S 96, G 3,
     bq = bk = 32) in f32 and bf16; then CUDA-event times of the kernel, the
     plain version and ``scaled_dot_product_attention`` (the library
     yardstick, which the port never calls) at the training shape in bf16,
     beside the operation bound.
4. Full-width qwen2-1.5b (28 layers, seed-0 random weights, bf16
   activations, flash_decode=True) serves 8 requests through ServeEngine —
   two share a 300-token prefix, so prefix hits and copy-on-write run —
   once with bf16 pools and once with int8 pools.  Every request returns
   32 tokens, logits stay finite, the kernel launches once per layer per
   tick, and the pools never move.  CUDA events around every kernel launch
   give the kernel's device time per tick; a repeat of the bf16 run under
   ``torch.profiler`` gives the device's busy time per tick by kernel.
5. The kernel route against the gather route at full width in f32: after a
   prefill step, one ragged step of a mixed pack from the same state
   through each route; logits agree to rtol 1e-3 (atol 1e-3 x max |logit|).
6. Full-width qwen2-1.5b training (28 layers, seed-0 random weights, bf16
   activations over float32 parameters and AdamW moments, remat "full",
   use_flash=True) on the repo's train_4k shape (sequence 4096) cut to batch
   2: four ``TrainLoop`` steps at lr 3e-4.  Every loss is finite; the
   flash kernel launched exactly 2 x 28 times a step (each layer's forward
   and its recomputation in the backward pass); per step: time, tokens/s
   and the model-FLOPs share (6 N tokens over time x 989 TFLOP/s); peak
   memory and the allocator's cudaMalloc/cudaFree counts.  One more step
   under ``torch.profiler`` (CUDA activity) gives the device's busy time,
   its idle share, the kernel's share and the top kernels; another (CPU
   activity) the host ops by self time; then every parameter gets a finite
   gradient.
7. The kernel route against the chunked route of training at full width in
   f32, the stage cut to 4 layers, batch 1, sequence 4096: ``loss_fn``
   agrees to rtol 1e-4 and every gradient leaf to atol 1e-3 x its max |g|.

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type

KERNELS = {
    "ragged_paged_flash": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ragged_paged_flash.cu",
        "replaces": "src/repro/kernels/flash_attention.py:273",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:349",
    },
}
BF16_PEAK = PEAK_FLOPS[torch.bfloat16]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 3. kernel against its plain version


def make_pack(kind: str, *, B=8, kvH=2, G=6, hd=128, page=16, cache_len=2048,
              T=256, seed=0):
    """A full-width ragged pack like the engine builds.  ``kind`` "decode":
    one decode token per slot, the rest of the budget invalid (lens 0);
    "mixed": decode tokens for six slots, a 128-token prefill chunk
    continuing slot 6 and a 100-token first chunk of slot 7, then an
    invalid tail.  Each slot maps only the pages it uses; the rest of its
    block-table row is the sentinel ``n_pages``.  Returns float32 q and
    pools and the int32 index tensors, on the CPU."""
    rng = np.random.RandomState(seed)
    pps = cache_len // page
    n_pages = B * pps
    fills = [1800, 1500, 1100, 700, 420, 200, 64, 0]  # context before the pack
    decoding = range(B) if kind == "decode" else range(6)
    lens, slot = [], []
    for b in decoding:  # a decode token sits at position fill: sees fill + 1
        slot.append(b)
        lens.append(fills[b] + 1)
    if kind == "mixed":
        for b, n in ((6, 128), (7, 100)):
            slot += [b] * n
            lens += list(range(fills[b] + 1, fills[b] + n + 1))
    slot += [0] * (T - len(slot))
    lens += [0] * (T - len(lens))
    perm = rng.permutation(n_pages)
    ptab = np.full((B, pps), n_pages, np.int32)
    for b in range(B):
        used = -(-max([l for l, s in zip(lens, slot) if s == b] + [1]) // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    normal = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    q = normal(T, kvH, G, hd)
    kp = normal(n_pages, page, kvH, hd)
    vp = normal(n_pages, page, kvH, hd)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return q, kp, vp, i32(ptab), i32(slot), i32(lens)


def kernel_inputs(pack, q_dtype, kv_dtype, device):
    from repro_torch.kernels import ops

    q, kp, vp, ptab, slot, lens = (t.to(device) for t in pack)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp, ks = ops.quantize_kv(kp)
        vp, vs = ops.quantize_kv(vp)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), ptab, slot,
            lens, ks, vs)


def bound(args) -> tuple:
    """(ms, "bytes" | "operations"): the least time for this call.  Bytes:
    each input the result depends on read once — the KV pages the pack's
    live tokens (lens > 0) reach, their scale rows, those tokens' q rows,
    ``lens`` for every row and ``slot`` for the live ones, and the
    block-table entries they use — and the whole output written once (the
    zero rows of invalid tokens included).  FLOPs 4 * sum(lens) * G * kvH
    * hd at the peak rate of q's type."""
    q, kp, vp, ptab, slot, lens, ks, vs = args
    T, kvH, G, hd = q.shape
    page = kp.shape[1]
    lens_c, slot_c = lens.cpu().numpy(), slot.cpu().numpy()
    live = lens_c > 0
    n_live = int(live.sum())
    pages, entries = set(), 0
    for b in set(slot_c[live].tolist()):
        n = -(-int(lens_c[live & (slot_c == b)].max()) // page)
        entries += n
        pages.update(np.minimum(ptab[b, :n].cpu().numpy(), kp.shape[0] - 1).tolist())
    page_bytes = page * kvH * hd * kp.element_size()
    if ks is not None:
        page_bytes += page * kvH * 4
    row = kvH * G * hd * q.element_size()
    nbytes = (2 * len(pages) * page_bytes + n_live * row + T * row
              + T * 4 + n_live * 4 + entries * 4)
    flops = 4.0 * float(lens_c.sum()) * G * kvH * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(card: str) -> dict:
    from repro_torch.kernels import ragged_paged_flash as rpf

    dev = torch.device("cuda")
    pack = make_pack("mixed")
    errs = {}
    for q_dt in (torch.float32, torch.bfloat16):
        for kv_dt in (torch.float32, torch.bfloat16, torch.int8):
            args = kernel_inputs(pack, q_dt, kv_dt, dev)
            got = rpf.ragged_paged_flash(*args[:6], ks=args[6], vs=args[7])
            torch.cuda.synchronize()
            want = rpf.ragged_paged_flash_ref(*args[:6], ks=args[6], vs=args[7])
            tol = (dict(rtol=1e-4, atol=1e-4) if q_dt == torch.float32
                   else dict(rtol=0.0, atol=2e-2))
            torch.testing.assert_close(got.float(), want.float(), **tol)
            dead = args[5] == 0
            assert bool((got[dead] == 0).all()), "lens == 0 rows must be zeros"
            err = float((got.float() - want.float()).abs().max())
            errs[(q_dt, kv_dt)] = err
            print(f"kernel vs plain: q {q_dt} pools {kv_dt}: max |err| {err:.3e}"
                  f" (tol {tol})")

    timings = {}
    for kind in ("decode", "mixed"):
        args = kernel_inputs(make_pack(kind), torch.bfloat16, torch.bfloat16, dev)
        ms = cuda_ms(lambda: rpf.ragged_paged_flash(*args[:6]))
        plain = cuda_ms(lambda: rpf.ragged_paged_flash_ref(*args[:6]), iters=10)
        b_ms, b_by = bound(args)
        timings[kind] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        print(f"ragged_paged_flash {kind} tick (T=256, bf16 q and pools) on "
              f"{card}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), share of bound {b_ms / ms:.3f}; "
              f"library call: none")
    return {"err": errs[(torch.bfloat16, torch.bfloat16)], "timings": timings}


def flash_inputs(BH, BKV, S, hd, dtype, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((BH, S, hd), (BKV, S, hd), (BKV, S, hd))]


def flash_bound(q, k, window=None) -> tuple:
    """(ms, "bytes" | "operations"): q, k and v read once and the output
    written once; 4 * hd FLOPs for each (row, col) pair the mask keeps —
    0 <= row - col < window (S without one) — in each of the BH rows, at
    the peak rate of the inputs' type."""
    BH, S, hd = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    W = S if window is None else min(window, S)
    pairs = W * S - W * (W - 1) // 2
    flops = 4.0 * hd * pairs * BH
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


FLASH_BF16_ROW_RTOL = 1e-2


def row_rel_err(got, want) -> float:
    """Largest |got - want| / |want| over the output rows (one query row of
    one head, hd values), both taken in float32."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def check_flash(card: str) -> dict:
    """The kernel against its plain version.  bf16 is held twice: each
    element to atol 2e-2, and each output row to FLASH_BF16_ROW_RTOL of the
    row's norm — about 2.5 bf16 rounding units (2^-8).  The row bound is the
    tight one where most of the work is: a long causal row averages about
    row/e keys, so its values are small (|o| ~ 0.03 at row 4096) and a fixed
    atol would not see an error that scales with them."""
    from repro_torch.kernels import flash_attention as fa

    main = dict(BH=24, BKV=4, S=4096, hd=128)  # qwen2-1.5b at batch 2
    odd = dict(BH=6, BKV=2, S=96, hd=128)
    cases = [("main", main, torch.float32, None, 128),
             ("main", main, torch.bfloat16, None, 128),
             ("windowed", main, torch.bfloat16, 512, 128),
             ("odd", odd, torch.float32, None, 32),
             ("odd", odd, torch.bfloat16, None, 32)]
    errs = {}
    for name, shape, dt, window, blk in cases:
        q, k, v = flash_inputs(**shape, dtype=dt)
        got = fa.flash_attention(q, k, v, bq=blk, bk=blk, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, window)
        tol = (dict(rtol=1e-4, atol=1e-4) if dt == torch.float32
               else dict(rtol=0.0, atol=2e-2))
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = float((got.float() - want.float()).abs().max())
        rel = row_rel_err(got, want)
        if dt == torch.bfloat16:
            assert rel <= FLASH_BF16_ROW_RTOL, (name, rel)
            tol = {**tol, "row_rtol": FLASH_BF16_ROW_RTOL}
        errs[(name, dt)] = err
        print(f"flash_attention vs plain: {name} {tuple(q.shape)} over "
              f"{tuple(k.shape)} {dt} window {window}: max |err| {err:.3e}, "
              f"max row |err| / |ref| {rel:.3e}, median |ref| "
              f"{float(want.float().abs().median()):.3e} (tol {tol})")
        del q, k, v, got, want

    out = {"err": errs[("main", torch.bfloat16)]}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(**main, dtype=dt)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters=20, warmup=3)
        plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), iters=5,
                        warmup=1)
        q4 = q.view(2, 12, 4096, 128)
        k4, v4 = (t.view(2, 2, 4096, 128) for t in (k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True, enable_gqa=True)
        lib = cuda_ms(sdpa, iters=20, warmup=3)
        diff = float((sdpa().reshape(q.shape).float()
                      - fa.flash_attention(q, k, v).float()).abs().max())
        b_ms, b_by = flash_bound(q, k)
        print(f"flash_attention at the training shape {tuple(q.shape)} {dt} on "
              f"{card}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms (max |diff| to the "
              f"kernel {diff:.3e}), bound {b_ms:.5f} ms ({b_by}), share of "
              f"bound {b_ms / ms:.4f}, kernel / library {ms / lib:.2f}")
        if dt == torch.bfloat16:
            out.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
        del q, k, v, q4, k4, v4
    return out


# ---------------------------------------------------------------------------
# 4. full-width serving


def _device_us(evt) -> float:
    """Device self time of a profiler event, in µs, across torch versions."""
    t = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if t is None else t


def serve_full(params, cfg, kv_dtype, card: str, *, profiled: bool = False) -> dict:
    """Serve the phase-4 workload once.  CUDA events around every kernel
    launch sum the kernel's device time; with ``profiled`` the run is traced
    by ``torch.profiler`` (CUDA activity only) and the device time of every
    kernel it ran is summed too."""
    from repro_torch.kernels import ragged_paged_flash as rpf
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.RandomState(1)
    eng = ServeEngine(params, cfg, batch_size=8, cache_len=2048, page_size=16,
                      prefill_chunk=128, token_budget=256, flash_decode=True,
                      kv_dtype=kv_dtype, device=params.device)
    step = eng._ragged_step

    def checked_step(*a):
        logits, state = step(*a)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        return logits, state

    eng._ragged_step = checked_step
    spans = []  # (start, end) CUDA events around each kernel launch
    kernel = rpf.ragged_paged_flash

    def timed_kernel(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = kernel(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    ptrs = [t.data_ptr() for t in eng.pool_tensors()]
    prefix = rng.randint(0, cfg.vocab_size, 300)
    prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 40)])]
    prompts += [rng.randint(0, cfg.vocab_size, n)
                for n in (32, 700, 450, 96, 260, 610)]
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profiled
        else contextlib.nullcontext())
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rpf.ragged_paged_flash = timed_kernel
    try:
        with prof:
            t0 = time.perf_counter()
            handles = [eng.submit(p, max_tokens=32) for p in prompts]
            for _ in range(4):  # let the shared prefix be prefilled and indexed
                eng.tick()
            late = np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 60)])
            handles.append(eng.submit(late, max_tokens=32))
            results = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        rpf.ragged_paged_flash = kernel
    st = eng.stats
    assert all(len(results[h]) == 32 for h in handles), \
        {int(h): len(results[h]) for h in handles}
    assert st["prefix_hits"] >= 1 and st["cow_copies"] >= 1, st
    assert st["kernel_launches"] == cfg.n_layers * st["ragged_ticks"], st
    assert len(spans) == st["kernel_launches"], (len(spans), st)
    assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs, "pools moved"
    assert eng.pool.pages_in_use == 0 and eng.reclaimable_pages == eng.n_pages
    toks = sum(len(results[h]) for h in handles)
    ticks = st["ticks"]
    kernel_ms = sum(a.elapsed_time(b) for a, b in spans)
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = "profiled repeat, " if profiled else ""
    print(f"serve qwen2-1.5b FULL ({cfg.n_layers} layers), pools {kv_dtype}, "
          f"{tag}on {card}: {len(handles)} requests, {toks} tokens in "
          f"{wall:.3f} s = {toks / wall:.1f} tokens/s, {st['ragged_ticks']} "
          f"ticks, {1e3 * wall / ticks:.2f} ms/tick, peak memory {peak:.2f} "
          f"GiB, prefix hits {st['prefix_hits']}, COW copies "
          f"{st['cow_copies']}, kernel launches {st['kernel_launches']}")
    print(f"  attention kernel in this run (CUDA events): {kernel_ms:.3f} ms "
          f"over {len(spans)} launches = {kernel_ms / len(spans):.4f} ms per "
          f"launch, {kernel_ms / ticks:.3f} ms per tick, "
          f"{kernel_ms / (1e3 * wall):.3f} of the wall time")
    out = dict(wall_ms=1e3 * wall, ticks=ticks, kernel_ms=kernel_ms,
               busy_ms=None)
    if profiled:
        by_name = {}
        for e in prof.key_averages():
            us = _device_us(e)
            if us > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
        busy = sum(by_name.values())
        if busy == 0:
            print("  profiler: no device time recorded (not measured)")
        else:
            out["busy_ms"] = busy
            print(f"  profiler: device busy {busy:.3f} ms = {busy / ticks:.3f} "
                  f"ms per tick, {busy / (1e3 * wall):.3f} of this run's wall "
                  f"time; top kernels by device time:")
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                print(f"    {ms:9.3f} ms  {ms / busy:.3f}  {name[:110]}")
    return out


# ---------------------------------------------------------------------------
# 5. kernel route against gather route


def pack(chunks, T, tokens):
    """Pack vectors for [(slot, first position, count)] chunks in order;
    logit_idx points at each listed slot's last token (T for the rest)."""
    B = max(b for b, _, _ in chunks) + 1
    slot = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    seq = np.zeros(T, np.int32)
    valid = np.zeros(T, bool)
    logit_idx = np.full(B, T, np.int32)
    n = 0
    for b, start, c in chunks:
        slot[n:n + c] = b
        q_pos[n:n + c] = start + np.arange(c)
        seq[n:n + c] = np.arange(c)
        valid[n:n + c] = True
        logit_idx[b] = n + c - 1
        n += c
    assert n <= T
    return [tokens[:T], slot, q_pos, seq, valid, logit_idx]


def route_logits(params, cfg, flashes, *, B, T, cache_len, page, seed):
    """Prefill a chunk for every slot from a fresh state (gather route),
    then run ONE mixed ragged step — half the slots decode one token, the
    other half prefill on — from that same state once per entry of
    ``flashes`` (each on its own copy of the state).  Returns the logits of
    each run, in order."""
    from repro_torch.models import model as M

    dev = params.device
    pps = cache_len // page
    n_pages = B * pps
    state = M.init_paged_state(params, cfg, B, cache_len, page_size=page,
                               n_pages=n_pages)
    rows = torch.arange(n_pages, dtype=torch.int32, device=dev).reshape(B, pps)
    tmpl = {"layers": [[{k: v.clone() for k, v in c.items()} for c in ss]
                       for ss in state["layers"]]}
    M.reset_paged_slots(cfg, state, tmpl, torch.ones(B, dtype=torch.bool, device=dev),
                        rows, torch.zeros(B, dtype=torch.int32, device=dev))
    rng = np.random.RandomState(seed)
    first = [T // B - 1 - b for b in range(B)]  # prefilled lengths
    half = B // 2
    mixed = ([(b, first[b], 1) for b in range(half)]
             + [(b, first[b], (T - half) // (B - half) - 1) for b in range(half, B)])

    def step(st, chunks, flash):
        vecs = pack(chunks, T, rng.randint(0, cfg.vocab_size, T).astype(np.int32))
        with torch.no_grad():
            logits, _ = M.ragged_step(
                params, cfg, st, *(torch.from_numpy(a).to(dev) for a in vecs),
                width=T, flash_decode=flash)
        return logits.float().cpu()

    step(state, [(b, 0, first[b]) for b in range(B)], False)
    out = []
    for flash in flashes:
        copy = {"layers": [[{k: v.clone() for k, v in c.items()} for c in ss]
                           for ss in state["layers"]]}
        rng = np.random.RandomState(seed + 1)  # the same tokens every run
        out.append(step(copy, mixed, flash))
    return out


# ---------------------------------------------------------------------------
# 6. full-width training


def flash_launches_per_step(cfg) -> int:
    """Flash-kernel launches in one training step: one per layer in the
    forward pass, and one more per layer when remat recomputes the block in
    the backward pass (tests/test_torch_train.py holds this on the CPU)."""
    return cfg.n_layers * (1 if cfg.remat == "none" else 2)


def train_full(card: str, steps: int = 4) -> dict:
    from repro_torch.configs import SHAPES_BY_NAME, get_config, param_count
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainLoop

    cfg = get_config("qwen2-1.5b").replace(use_flash=True)
    shape = SHAPES_BY_NAME["train_4k"]
    B = 2
    loop = TrainLoop(cfg, shape, lr=3e-4, total_steps=steps, batch_override=B,
                     device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0  # count only the main path's launches
    hist = loop.run(steps)
    launches = fa.launches
    per_step = flash_launches_per_step(cfg)
    assert launches == per_step * steps, (launches, per_step, steps)
    assert all(np.isfinite(r["loss"]) for r in hist), hist
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = B * shape.seq_len
    n = param_count(cfg)
    print(f"train qwen2-1.5b FULL ({cfg.n_layers} layers, {n / 1e9:.3f} B "
          f"params), seq {shape.seq_len}, batch {B}, bf16 activations, f32 "
          f"params, remat {cfg.remat}, use_flash, on {card}: flash kernel "
          f"launches {launches} = {per_step} per step x {steps} steps; peak "
          f"memory {peak:.2f} GiB")
    for r in hist:
        t = r["time_s"]
        print(f"  step {r['step']}: loss {r['loss']:.4f}, {1e3 * t:.1f} ms, "
              f"{tokens / t:.0f} tokens/s, model-FLOPs share "
              f"{6 * n * tokens / (t * BF16_PEAK):.4f}")

    mem = torch.cuda.memory_stats()
    print(f"  allocator over the {steps} steps: {mem.get('num_device_alloc')} "
          f"cudaMalloc, {mem.get('num_device_free')} cudaFree, "
          f"{mem.get('num_alloc_retries')} allocation retries")

    state = loop.final_state
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in loop.data.batch_at(steps).items()}

    def traced_step(activity):
        """One more train step under ``torch.profiler`` tracing ``activity``;
        returns (key_averages, wall ms)."""
        nonlocal state
        prof = torch.profiler.profile(activities=[activity])
        torch.cuda.synchronize()
        with prof:
            t0 = time.perf_counter()
            state, metrics = loop.step_fn(state, batch)
            assert np.isfinite(float(metrics["loss"])), metrics["loss"]
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        return prof.key_averages(), wall

    events, wall = traced_step(torch.profiler.ProfilerActivity.CUDA)
    by_name, n_device = {}, 0
    for e in events:
        us = _device_us(e)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            n_device += e.count
    busy = sum(by_name.values())
    step_ms = [1e3 * r["time_s"] for r in hist]
    steady = float(np.median(step_ms[1:]))  # step 0 warms cuBLAS and the allocator
    out = dict(launches=launches, step_ms=step_ms, busy_ms=None)
    if busy == 0:
        print("  profiler: no device time recorded (not measured)")
    else:
        fa_ms = sum(ms for name, ms in by_name.items()
                    if "flash_attention_kernel" in name)
        out["busy_ms"] = busy
        print(f"  profiled step (CUDA activity) on {card}: {wall:.1f} ms wall, "
              f"device busy {busy:.1f} ms in {n_device} kernels and copies; "
              f"idle share {1 - busy / wall:.3f} of this step, "
              f"{1 - busy / steady:.3f} of the median unprofiled step "
              f"({steady:.1f} ms, steps 1-{steps - 1}); flash kernel "
              f"{fa_ms:.1f} ms = {fa_ms / busy:.3f} of the busy time "
              f"({fa_ms / per_step:.3f} ms per launch); top kernels by device "
              f"time:")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"    {ms:9.3f} ms  {ms / busy:.3f}  {name[:110]}")
        groups = {"flash kernel": 0.0, "GEMM": 0.0, "softmax": 0.0,
                  "copies and casts": 0.0, "other": 0.0}
        for name, ms in by_name.items():
            low = name.lower()
            if "flash_attention_kernel" in name:
                g = "flash kernel"
            elif any(t in low for t in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
                g = "GEMM"
            elif "softmax" in low:
                g = "softmax"
            elif "copy" in low or "memcpy" in low or "memset" in low:
                g = "copies and casts"
            else:
                g = "other"
            groups[g] += ms
        print("  device time by kind: " + ", ".join(
            f"{g} {ms:.1f} ms ({ms / busy:.3f})" for g, ms in groups.items()))
    events, wall = traced_step(torch.profiler.ProfilerActivity.CPU)
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in events) / 1e3
    print(f"  profiled step (CPU activity): {wall:.1f} ms wall, "
          f"{sum(e.count for e in events)} host ops, {total:.1f} ms of host "
          f"self time; top host ops by self time:")
    for e in host[:10]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")

    params = state["params"]
    leaves = list(params.parameters())
    loss, _ = M.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    names = [n for n, _ in params.named_parameters()]
    missing = [nm for nm, g in zip(names, grads) if g is None]
    assert not missing, f"no gradient reached {missing}"
    bad = [nm for nm, g in zip(names, grads) if not bool(torch.isfinite(g).all())]
    assert not bad, f"non-finite gradients in {bad}"
    print(f"  gradients reach all {len(leaves)} parameter leaves, all finite")
    return out


# ---------------------------------------------------------------------------
# 7. kernel route against chunked route (training)


def train_routes(card: str) -> None:
    from repro_torch.configs import ShapeCfg, Stage, get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import model as M

    full = get_config("qwen2-1.5b")
    cfg = full.replace(dtype="float32",
                       stages=(Stage(full.stages[0].pattern, 4),))
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda", for_training=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMData(
        cfg, ShapeCfg("route", 4096, 1, "train"), seed=3).batch_at(0).items()}
    leaves = list(params.parameters())
    res = {}
    for flash in (True, False):
        loss, _ = M.loss_fn(params, cfg.replace(use_flash=flash), batch)
        res[flash] = (loss.item(), torch.autograd.grad(loss, leaves))
    (lf, gf), (lc, gc) = res[True], res[False]
    np.testing.assert_allclose(lf, lc, rtol=1e-4)
    worst = 0.0
    for name, a, b in zip([n for n, _ in params.named_parameters()], gf, gc):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-3 * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")
        worst = max(worst, float((a - b).abs().max()) / max(scale, 1e-30))
    print(f"training, kernel route vs chunked route, full width f32 "
          f"(4 layers, seq 4096, batch 1) on {card}: loss {lf:.6f} vs "
          f"{lc:.6f}; worst gradient leaf max |diff| / max |g| {worst:.3e} "
          f"over {len(leaves)} leaves")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import ragged_paged_flash as rpf
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build_all(KERNELS)
    print(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, together)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kres = check_kernel(card)
    fres = check_flash(card)

    cfg = get_config("qwen2-1.5b")  # FULL, bf16 activations
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    rpf.launches = 0  # count only the main path's launches
    plain = serve_full(params, cfg, None, card)
    launches = rpf.launches
    assert launches > 0, "the serving path never launched the kernel"
    serve_full(params, cfg, "int8", card)
    traced = serve_full(params, cfg, None, card, profiled=True)
    if traced["busy_ms"] is not None:
        busy_tick = traced["busy_ms"] / traced["ticks"]
        wall_tick = plain["wall_ms"] / plain["ticks"]
        print(f"bf16 pools on {card}: device busy {busy_tick:.3f} ms per tick "
              f"(profiled repeat) against {wall_tick:.3f} ms per tick of wall "
              f"time (first run): idle share {1 - busy_tick / wall_tick:.3f}")
    del params
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(dtype="float32")
    p32 = M.init_params(cfg32, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    lf, lg = route_logits(p32, cfg32, (True, False), B=8, T=256,
                          cache_len=2048, page=16, seed=2)
    scale = float(lg.abs().max())
    torch.testing.assert_close(lf, lg, rtol=1e-3, atol=1e-3 * scale)
    print(f"kernel route vs gather route, full width f32: max |diff| "
          f"{float((lf - lg).abs().max()):.3e} (max |logit| {scale:.2f})")
    del p32
    torch.cuda.empty_cache()

    tres = train_full(card)
    torch.cuda.empty_cache()
    train_routes(card)

    t = kres["timings"]["mixed"]
    print(card)
    print(json.dumps({"kernels": [
        {"name": "ragged_paged_flash", **KERNELS["ragged_paged_flash"],
         "launches": launches, "max_abs_err": kres["err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": None},
        {"name": "flash_attention", **KERNELS["flash_attention"],
         "launches": tres["launches"], "max_abs_err": fres["err"],
         **{k: fres[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
