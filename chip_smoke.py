"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (every check asserts; any failure exits non-zero):

1. Card, power limit, torch/CUDA versions; TF32 off for matmul and cuDNN.
2. Build the CUDA kernel of the serving path from ``src/repro_torch`` and
   print ptxas's register and shared-memory report.
3. Each kernel against its plain PyTorch version at full-width shapes
   (qwen2-1.5b: kvH 2, G 6, hd 128; page 16; cache_len 2048; a 256-token
   mixed pack of decode and prefill tokens from 8 slots, with unmapped
   (sentinel) pages and lens == 0 rows), for q in {f32, bf16} x pools in
   {f32, bf16, int8}.  Tolerance: f32 outputs rtol = atol = 1e-4; bf16
   outputs atol = 2e-2, compared in f32.  Then CUDA-event times of the
   kernel and the plain version at a steady decode tick and a mixed tick,
   beside the byte/operation bound.
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
}


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
    (name,) = KERNELS
    log = build.build(name)
    print(f"built {name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  {name}: {line.strip()}")

    kres = check_kernel(card)

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

    t = kres["timings"]["mixed"]
    print(card)
    print(json.dumps({"kernels": [{
        "name": name, **KERNELS[name], "launches": launches,
        "max_abs_err": kres["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
