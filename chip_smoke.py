"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (every check asserts; any failure exits non-zero):

1. Card, power limit, torch/CUDA versions; TF32 off for matmul and cuDNN.
2. Build the five CUDA kernels from ``src/repro_torch`` (the serving,
   two-phase decode, training, RMSNorm and matmul kernels), one ``nvcc`` per
   source started together, and print ptxas's register and spill report;
   count the wgmma (HGMMA) and TMA (UTMALDG) instructions in the
   flash_attention and matmul libraries' SASS and the tensor-core (HMMA)
   instructions in ragged_paged_flash's and paged_flash_decode's, and fail
   if any is 0.
3. Each kernel against its plain PyTorch version at full-width shapes.
   Tolerance: f32 outputs rtol = atol = 1e-4; bf16 outputs atol = 2e-2,
   compared in f32, and for the attention kernels also each output row
   within 1e-2 of its norm.  ``device_ms`` is the device's own time per
   call (``torch.profiler``, CUDA activity), beside the CUDA-event time of
   a loop of calls, which includes the wrapper's host path where that is
   longer than the kernel.
   - ragged_paged_flash (qwen2-1.5b: kvH 2, G 6, hd 128; page 16;
     cache_len 2048; a 256-token mixed pack of decode and prefill tokens
     from 8 slots, with unmapped (sentinel) pages and lens == 0 rows), for
     q in {f32, bf16} x pools in {f32, bf16, int8}, each case's variant
     (``ragged_variant``: "mma" for bf16 q over bf16/int8 pools, "simt"
     otherwise) printed; then CUDA-event and device times of the kernel
     and event times of the plain version at a steady decode tick and a
     mixed tick, warm (the same pools every call) and cold (rotating over
     copies of the pools that together exceed the 50 MB L2), beside the
     byte/operation bound.  Then, bf16 q over bf16 and int8 pools, each
     through "mma" with the same tolerances, device time beside the bound:
     the mixed pack at glm4-9b's head layout (kvH 2, G 16), qwen1.5-4b's
     (kvH 20, G 1), llama4-maverick's (kvH 8, G 5) and jamba's (kvH 8,
     G 8), and a verify pack at glm4-9b's (8 slots, lens up to
     2048: each slot's decode token, then its 4 draft tokens as a later
     run, as the speculative engine packs them).
   - flash_attention at llama-3.2-vision-11b's self-attention shape (q
     (32, 4096, 128) over k/v (8, 4096, 128): batch 1 x 8 KV heads x 4
     query heads each, causal, bf16, "wgmma"), held against its plain
     version, device time beside SDPA and the operation bound.
   - flash_attention at the training shape (q (24, 4096, 128) over k/v
     (4, 4096, 128): batch 2 x 2 KV heads x 6 query heads each) in f32 and
     bf16, windowed (window 512, bf16), a small odd case (S 96, G 3,
     bq = bk = 32) in f32 and bf16, and gemma3-4b's global layers (q (8,
     4096, 256) over k/v (4, 4096, 256), batch 1) in f32 and bf16 with
     window none and 512, each case's variant ("wgmma" for bf16 at hd 64
     and 128, "simt" otherwise, as ``flash_variant`` says) and TFLOP/s
     printed; then
     CUDA-event and device times of the kernel, event times of the plain
     version and ``scaled_dot_product_attention`` (the library yardstick,
     which the port never calls) at the training shape in bf16 and f32,
     beside the operation bound; and at gemma3's global shape, f32 and
     bf16, device time beside the plain version, SDPA and the bound.
   - paged_flash_decode at phase 4's decode tick (8 slots, lens up to
     2048, one empty slot, sentinel pages), q in {f32, bf16} x pools in
     {f32, bf16, int8}, each case's variant (``kernel_variant``: "mma" for
     bf16 q over bf16/int8 pools, "simt" otherwise) printed; then, for bf16
     q over bf16 and int8 pools, CUDA-event and device times at key splits
     of 64, 128 and 256 keys, warm and cold (rotating over pool copies
     larger than the L2), beside the byte bound, the plain version and
     ragged_paged_flash on the same pack with ``slot = arange(B)``.
   - matmul, both accumulation policies, f32 and bf16, at 4096^3 and
     1000 x 1500 x 700, against its plain version (f32: rtol 1e-4; bf16:
     rtol 2^-7, one rounding unit; each with an atol of 2^-16 (f32) or
     2^-12 (bf16) x sqrt(K) x rms|a| x rms|b|), each case's route
     (``matmul_route``: TMA or register-staged wgmma for bf16, cp.async or
     scalar-load FMA for f32) printed; event and device times and TFLOP/s
     beside ``torch.matmul`` and the bound (the "hbm" policy's bytes count
     its C passes).
   - both serving kernels at gemma3-4b's head layout (4 KV heads, 2
     query heads each, head_dim 256: the "simt" variant), kernel 1 on the
     mixed pack, kernel 2 on the decode tick, bf16 q over bf16 and int8
     pools: against the plain versions (bf16 tolerances above), device
     time beside the bound, the plain version's event time.
   - rmsnorm at the serving pack (256 x 1536) and the training
     activations (8192 x 1536), f32 and bf16, against its plain version and
     ``torch.nn.functional.rms_norm`` (f32: 1e-5; bf16: rtol 2^-7), each
     case's route (``rmsnorm_plan``) printed; event and device times of
     both beside the byte bound.  Then the norm layer's kernel route
     (``norms.rmsnorm(use_kernel=True)``, which no model path sets, as in
     JAX) at both shapes: its own launch count.
4. Full-width qwen2-1.5b (seed-0 random weights, bf16 activations,
   flash_decode=True) serves 8 requests through ServeEngine — two share a
   300-token prefix, so prefix hits and copy-on-write run — through the
   ragged engine (its first 14 of 28 layers) and the two-phase engine
   (``ragged=False``: batched prefill chunks, then decode ticks through
   paged_flash_decode; its first 7 layers) — depth cut to keep the run's
   time since phases 4e-6c came in (``SERVE_LAYERS``, ``TWO_PHASE_LAYERS``)
   — each with
   bf16 and with int8 pools, each in two arms: captured (the default: each
   step replays its CUDA graph) and eager (``cuda_graph=False``).  Every
   request returns 32 tokens, the sampled logits stay finite, the pools
   never move, the engine counts the kernel's launches as the number of
   layers times its ticks (under replay, from the launches recorded at
   capture), and the captured transcripts equal the eager ones token for
   token.  The eager arm brackets every launch with CUDA events and holds
   every launch to the "mma" variant; the captured arm records no event
   into its graph.  Each arm is repeated under ``torch.profiler`` with CUDA
   activity — device busy time per tick, the idle share against the arm's
   unprofiled wall time, the serving kernel's device time per launch, and
   its "mma" attention kernel's instances (traced in one profiler cycle
   per tick), which must equal the layers times the kernel's ticks — on
   the captured arm the proof that the graph replays ran the kernel; a
   profiler that does not break the replays down fails the run.  With bf16
   pools each arm is also repeated under CPU activity: host ms per tick in
   the engine's admission, pack, step call, logits copy and sampling
   (``record_function`` ranges wrapped around the engine's methods here).
   Printed per path, pools and arm: wall ms per tick, tokens/s, busy ms per
   tick, idle share, host ranges.
4b. Speculative serving at full width: glm4-9b (untied head, seed-0
   random weights, bf16 activations; its first 20 of 40 layers,
   ``SPEC_LAYERS``, 5.32 B parameters) through the
   captured ragged engine (phase 4's settings) on 8 requests of 64–512
   prompt and 64 output tokens (four tiled prompts, four over tokens 1–4),
   at spec_k 0 and 4, with bf16 and with int8 pools.  Per pool type the two
   transcripts are equal; at spec_k 4 drafted = accepted + rejected,
   drafts are accepted and rolled back; the engine counts 20 kernel
   launches per ragged tick, one trace, the pools never move.  The bf16
   arms are repeated under the CUDA profiler, whose "mma" attention-kernel
   instances must equal that count.  Printed per arm: ticks, wall ms per
   tick, tokens/s, tokens per sampled slot-tick, busy ms per tick and idle
   share (bf16), the host ms of the logits copy.
4c. The host tier, preemption and faults at full width: qwen2-1.5b
   (phase 4's 14 layers, seed-0 random weights, bf16 activations) through
   the captured ragged engine at phase 4's settings, bf16 and int8 pools.
   Tier: waves A (8 requests over prefix families 0-7: a 1024-token family
   prefix, a 64-token suffix, 32 output tokens), B (families 8-15, which push A's
   prefixes out of a 600-page device pool) and A' (A's prompts again),
   with 1024 host slots (pinned) and without: tiered transcripts equal the
   untiered ones, wave A' hits the host tier and promotes pages; the same
   waves again with a seeded ``FaultInjector`` (allocation failures,
   cancels, host eviction storms, stalled ticks at 0.05 a tick each):
   every completed transcript equals the fault-free one.  Wave A' of the
   bf16 tiered run is repeated under the CUDA profiler (one cycle per
   tick): busy time and idle share, the serving kernel's "mma" instances
   equal to the engine's launches, and the movers' memcpys (from each
   cycle's trace, by their bytes) beside one contiguous pinned copy of the
   same bytes.  Preemption (scheduler ``slo``): 8 batch requests of 512
   prompt and 256 output tokens fill a pool of their footprint, 4
   priority-1 requests of 128 and 32 arrive after 8 ticks; with 128 host
   slots (park-hit resumes) and with none (re-prefill resumes), both equal
   to a 12-slot run with room for everyone, and (bf16) with
   ``preempt=False``: the interactive requests' ticks to first token.
   Every run: one trace, one graph, the pools in place, both tiers
   drained, and the movers run under CUDA's sync debug mode at "error"
   (a mover that waits for the card raises, as far as the mode detects).
   Printed: wave A' wall ms and prefill tokens tiered against untiered,
   host ms in admission, the pool's eviction scans and the movers.
4d. Sliding-window serving at full width: gemma3-4b (34 layers, 29 of
   them windowed (window 1024, RoPE theta 1e4) and 5 global (theta 1e6),
   8 query heads over 4 KV heads at head_dim 256; seed-0 random weights,
   bf16 activations) through the ragged engine at phase 4's settings on 8
   requests of 200-1900 prompt tokens (five longer than the window) and 32
   output tokens, with bf16 and int8 pools, captured and eager: captured
   transcripts equal the eager ones; the windowed gates hold (no prefix
   cache, speculation or preemption); kernel 1 launches 5 times a tick,
   all "simt" (replay-aware when captured); the captured bf16 run repeated
   under the CUDA profiler, whose ragged_simt_kernel instances must equal
   that count.  Printed per arm: wall ms per tick, tokens/s, busy ms per
   tick and idle share (bf16 captured), peak memory, the device time of
   each admission's slot reset.  Then the lock-step ReferenceEngine at full
   depth (bf16) on an equal-length wave of 4 x 1200 prompt tokens (ms per
   decode tick), and the two-phase engine at the first 12 layers (10
   windowed, 2 global), bf16 and int8 pools: kernel 2 launched twice a
   decode tick.
4e. Recurrent serving at full width: xlstm-350m FULL (24 layers: 21
   mLSTM at 4 heads of head_dim 512, 3 sLSTM with a gated-gelu FFN; d 1024,
   0.499 B parameters; seed-0 weights, bf16 activations) through the ragged
   engine, captured and eager, at phase 4's batch and budget (prefill_chunk
   ``XLSTM_CHUNK``, so each tick rolls the single-step decode chunk + 1
   times a layer, JAX's design; 32, for the note at ``XLSTM_CHUNK``) on 8
   requests of 64–512 prompt and 32 output tokens: captured transcripts
   equal the eager ones; the recurrent
   gates hold (no prefix cache, speculation or preemption, no page
   reserved, no pool); no attention kernel launches (no paged layer); the
   state never moves.  A captured repeat profiles four ticks (two of
   prefill, two of decode) in their own CUDA profiler sessions: device busy
   time, idle share against the unprofiled run's same tick, and the kernels
   a replay runs.  Printed per arm: ms per tick, tokens/s, build and
   capture time, peak memory.
4f. MoE serving at full width: llama4-maverick-400b-a17b, its first
   period (2 layers: dense, then MoE; d 5120, 40 over 8 KV heads at hd
   128, 128 experts top-1 of d_ff 8192 plus the shared expert, untied
   vocab 202048; 18.55 B parameters, 37.1 GB in bf16; seed-0 weights, each
   leaf cast as it is drawn, bf16 activations) through phase 4's ragged
   workload (``serve_full``), captured and eager: captured transcripts
   equal the eager ones, prefix hits and copy-on-write, kernel 1 twice a
   tick, all "mma"; the captured arm repeated under the CUDA profiler
   (busy time, idle share, "mma" instances = launches).  The MoE layer
   alone on a (1, 256, d) pack (device time) beside the byte floor of its
   expert weights, which the dispatch reads whole every tick (32.2 GB /
   3.35 TB/s = 9.6 ms), and its share of the captured tick's busy time.
   Printed: ms per tick, tokens/s, busy ms, idle share, peak memory.
4g. Hybrid serving at full width: jamba-1.5-large-398b, the first five
   layers of its period (mamba+MLP, mamba+MoE, mamba+MLP, mamba+MoE,
   attention+MLP: every block kind; d 8192, d_in 16384, d_state 16, 16
   experts top-2 of d_ff 24576, 64 over 8 KV heads; 24.05 B parameters,
   48.1 GB in bf16) through the ragged engine at phase 4e's settings and
   wave (``JAMBA_KW``: prefill_chunk 32, so each Mamba layer rolls its
   single-step decode 33 times a tick), captured and eager: equal
   transcripts, the recurrent gates (no prefix cache, speculation or
   preemption), kernel 1 once a tick, all "mma"; the captured arm
   repeated under the CUDA profiler (busy time, idle share, instances =
   launches, kernels a replay); the MoE layers alone beside their
   expert-read floor, and the roll's Mamba weight reads (4 layers x 0.84
   GB x 33 a tick) beside the reading.
5. The kernel route against the gather route at full width in f32: after a
   prefill step, one ragged step of a mixed pack from the same state
   through each route; then, for the two-phase path, one decode tick after
   a (8, 512) prefill chunk, a prefilled slot riding along idle; then a
   verify pack (every slot's decode token, then 4 draft tokens each,
   ``logit_idx`` (8, 5)) at glm4-9b's widths cut to 4 layers, after
   prefills to lens up to 2048.  Logits agree to rtol 1e-3 (atol 1e-3 x
   max |logit|).  Then gemma3-4b at full width in f32, cut to 12 layers:
   an equal-length wave of 4 x 1100 prompt tokens (past the window), 16
   tokens each, through the lock-step ReferenceEngine and the captured
   ragged engine on both routes: equal greedy transcripts, first-step
   logits within the same tolerance.
6. Full-width qwen2-1.5b training (28 layers, seed-0 random weights, bf16
   activations over float32 parameters and AdamW moments, remat "full",
   use_flash=True) on the repo's train_4k shape (sequence 4096) cut to batch
   2: four ``TrainLoop`` steps at lr 3e-4.  Every loss is finite; the
   flash kernel launched exactly 2 x 28 times a step (each layer's forward
   and its recomputation in the backward pass), every launch through the
   "wgmma" variant; per step: time, tokens/s
   and the model-FLOPs share (6 N tokens over time x 989 TFLOP/s); peak
   memory and the allocator's cudaMalloc/cudaFree counts.  One more step
   under ``torch.profiler`` (CUDA activity) gives the device's busy time,
   its idle share, the kernel's share and the top kernels; another (CPU
   activity) the host ops by self time; then every parameter gets a finite
   gradient.
6b. gemma3-4b training at full width (d 2560, 8 query over 4 KV heads at
   head_dim 256, vocab 262144), cut to its first 12 layers (10 windowed, 2
   global), bf16 activations over float32 parameters and moments, remat
   "full", ``use_flash``: three ``TrainLoop`` steps at sequence 4096,
   batch 1.  Every loss is finite; the flash kernel launches 2 x 2 times a
   step (the global layers' forward and recomputation; the windowed layers
   take the chunked route, as in JAX), all "simt".  Per step: time and
   tokens/s; peak memory.
6c. xlstm-350m FULL training: three ``TrainLoop`` steps at sequence 1024,
   batch 1, bf16 activations over float32 parameters, remat "full" (no
   attention, so no ``use_flash``).  Every loss is finite and every
   parameter gets a finite gradient; per step: time; peak memory.
6d. hubert-xlarge FULL (48 layers, d 1280, 16 heads at head_dim 80,
   bidirectional, sinusoidal positions, the audio stub's frames from the
   seed): three ``TrainLoop`` steps at sequence 4096, batch 2, remat
   "full" (step time, tokens/s, peak memory; a fourth step profiled:
   busy ms, idle share, top kernels); then one encoder forward at
   prefill_32k's sequence (B 1, S 32768, bf16 weights, no grad): time,
   peak memory and the model-FLOPs share (projections plus bidirectional
   attention over 989 TFLOP/s).
6e. llama-3.2-vision-11b: (a) FULL (40 layers, 8 cross-attention layers
   over 1024 image tokens, bf16) through the lock-step path: B 4,
   cache_len 2048, 512-token prompts, 64 greedy decode steps (prefill ms,
   ms per decode step by CUDA events, tokens/s, peak memory, a profiled
   step's busy ms and idle share); the first
   decode step's logits agree with ``forward`` over prompt + token at its
   last position (each row within 5e-2 of its norm), and other image
   features change them.  (b) Training on its first period (4 self- and 1
   cross-attention layer, the full embedding and head: 2.15 B
   parameters), sequence 4096, batch 1, ``use_flash``: three steps with
   float32 moments and three with int8 moments (step time, peak memory of
   each arm, the loss difference); flash launches 4 x 3 a step (the
   forward, the group's recomputation and each block's own: the four
   self layers precede the cross one in the remat'd group), all "wgmma",
   equal to the profiled kernel instances of a fourth step.
6f. Checkpoint/resume on the card: hubert-xlarge at full width cut to 2
   layers, sequence 1024, batch 2: 8 straight steps; a run with
   ``save_every=3`` whose ``failure_hook`` fails once at step 5 (restore
   step 3 and replay) to step 6; a fresh ``TrainLoop`` resuming from the
   directory to step 8.  Every loss equals the straight run's at rtol
   1e-5; then the synchronous host snapshot ms, the background write s
   and the restore s of the final state.  The directory is removed.
7. The kernel route against the chunked route of training at full width in
   f32, batch 1, sequence 4096, for qwen2-1.5b cut to 4 layers and
   gemma3-4b cut to phase 6b's 12: ``loss_fn`` agrees to rtol 1e-4 and
   every gradient leaf to atol 1e-3 x its max |g|; the kernel launches
   twice a global layer, all "simt" (f32).
8. The paper's experiment from ``repro_torch.benchmarks``: the Fig. 4/5
   matmul sweep (cuBLAS and the matmul kernel, nproc 1 to 64, N =
   16384/sqrt(nproc), f32) and the 15-row memory-mode table (8192^3 f32),
   with the matmul kernel's launches counted, all through its float32 routes.

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L2_BYTES = 50 * 2 ** 20  # H100 SXM
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
    "paged_flash_decode": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_flash_decode.cu",
        "replaces": "src/repro/kernels/flash_attention.py:143",
    },
    "rmsnorm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:20",
    },
    "matmul": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:49",
    },
}
BF16_PEAK = PEAK_FLOPS[torch.bfloat16]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Device time per call of ``fn``: ``iters`` calls after ``warmup``
    under ``torch.profiler`` (CUDA activity only), the summed device time of
    every kernel they ran over ``iters``.  The profiler now and then records
    no device time; such a run is repeated, up to three in all, and None
    (not measured) is returned if none recorded any."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(_device_us(e) for e in prof.key_averages())
        if total > 0:
            return total / 1e3 / iters
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


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


# context before a verify pack's decode token, per slot: the longest slot's
# last draft sees cache_len = 2048 positions
VERIFY_FILLS = [2043, 1500, 1100, 700, 420, 200, 64, 16]


def make_pack(kind: str, *, B=8, kvH=2, G=6, hd=128, page=16, cache_len=2048,
              T=256, drafts=4, seed=0):
    """A full-width ragged pack like the engine builds.  ``kind`` "decode":
    one decode token per slot, the rest of the budget invalid (lens 0);
    "mixed": decode tokens for six slots, a 128-token prefill chunk
    continuing slot 6 and a 100-token first chunk of slot 7, then an
    invalid tail; "verify" (speculative decoding): every slot's decode
    token in a first section, then each slot's ``drafts`` draft tokens at
    the next consecutive positions as a run of its own, then an invalid
    tail.  Each slot maps only the pages it uses; the rest of its
    block-table row is the sentinel ``n_pages``.  Returns float32 q and
    pools and the int32 index tensors, on the CPU."""
    rng = np.random.RandomState(seed)
    pps = cache_len // page
    n_pages = B * pps
    fills = (VERIFY_FILLS if kind == "verify"
             else [1800, 1500, 1100, 700, 420, 200, 64, 0])  # context before the pack
    decoding = range(6) if kind == "mixed" else range(B)
    lens, slot = [], []
    for b in decoding:  # a decode token sits at position fill: sees fill + 1
        slot.append(b)
        lens.append(fills[b] + 1)
    if kind == "mixed":
        for b, n in ((6, 128), (7, 100)):
            slot += [b] * n
            lens += list(range(fills[b] + 1, fills[b] + n + 1))
    if kind == "verify":
        for b in range(B):
            slot += [b] * drafts
            lens += list(range(fills[b] + 2, fills[b] + drafts + 2))
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
    """A pack's q and pools in the given types on ``device``, int8 pools
    quantized with their scale pools: (q, kp, vp, *index tensors, ks, vs)."""
    from repro_torch.kernels import ops

    q, kp, vp, *index = (t.to(device) for t in pack)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp, ks = ops.quantize_kv(kp)
        vp, vs = ops.quantize_kv(vp)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), *index, ks, vs)


def kv_reached(kp, ks, ptab, row_lens) -> tuple:
    """(bytes, block-table entries) of the KV the given block-table rows
    reach: ``row_lens`` maps a row to its longest visible length; each
    unique pool page counts once, K and V, with its scale rows for int8."""
    page = kp.shape[1]
    pages, entries = set(), 0
    for b, n_len in row_lens.items():
        n = -(-n_len // page)
        entries += n
        pages.update(np.minimum(ptab[b, :n].cpu().numpy(), kp.shape[0] - 1).tolist())
    page_bytes = page * kp.shape[2] * kp.shape[3] * kp.element_size()
    if ks is not None:
        page_bytes += page * kp.shape[2] * 4
    return 2 * len(pages) * page_bytes, entries


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
    lens_c, slot_c = lens.cpu().numpy(), slot.cpu().numpy()
    live = lens_c > 0
    n_live = int(live.sum())
    kv_bytes, entries = kv_reached(kp, ks, ptab, {
        b: int(lens_c[live & (slot_c == b)].max())
        for b in set(slot_c[live].tolist())})
    row = kvH * G * hd * q.element_size()
    nbytes = (kv_bytes + n_live * row + T * row + T * 4 + n_live * 4
              + entries * 4)
    return roof(nbytes, 4.0 * float(lens_c.sum()) * G * kvH * hd, q.dtype)


# the instructions each library's SASS must hold: wgmma and TMA tile loads
# for flash and matmul, mma.sync for the two serving kernels
SASS_OPS = {"flash_attention": ("HGMMA", "UTMALDG"), "matmul": ("HGMMA", "UTMALDG"),
            "ragged_paged_flash": ("HMMA",), "paged_flash_decode": ("HMMA",)}


def sass_phase(card: str) -> dict:
    """Counts the instructions ``SASS_OPS`` names in each built library
    (``cuobjdump --dump-sass``); fails if any count is 0."""
    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, ops in SASS_OPS.items():
        sass = subprocess.run([tool, "--dump-sass", str(build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
        print(f"SASS of {name} (built for {card}): " + ", ".join(
            f"{n} {op}" for op, n in counts.items()) + " instructions")
        assert all(counts.values()), f"{name} lacks tensor-core or TMA code: {counts}"
        out[name] = counts
    return out


def check_kernel(card: str) -> dict:
    """Kernel 1 against its plain version on the mixed pack, every (q,
    pool) type pair, each through the variant ``ragged_variant`` names.  A
    bf16 output is held to atol 2e-2 and each output row to BF16_ROW_RTOL of
    its norm; ``lens == 0`` rows exactly zero.  Then times at the decode and
    the mixed tick in bf16: CUDA events over a loop of calls, the device's
    own time per call (``device_ms``), both warm and cold."""
    from repro_torch.kernels import ragged_paged_flash as rpf

    dev = torch.device("cuda")
    pack = make_pack("mixed")
    errs = {}
    for q_dt in (torch.float32, torch.bfloat16):
        for kv_dt in (torch.float32, torch.bfloat16, torch.int8):
            args = kernel_inputs(pack, q_dt, kv_dt, dev)
            rpf.reset_launches()
            got = rpf.ragged_paged_flash(*args[:6], ks=args[6], vs=args[7])
            torch.cuda.synchronize()
            variant = ran(rpf.launches_by_variant)
            assert variant == rpf.ragged_variant(q_dt, kv_dt, 128), (q_dt, kv_dt)
            want = rpf.ragged_paged_flash_ref(*args[:6], ks=args[6], vs=args[7])
            tol = (dict(rtol=1e-4, atol=1e-4) if q_dt == torch.float32
                   else dict(rtol=0.0, atol=2e-2))
            torch.testing.assert_close(got.float(), want.float(), **tol)
            dead = args[5] == 0
            assert bool((got[dead] == 0).all()), "lens == 0 rows must be zeros"
            err = float((got.float() - want.float()).abs().max())
            rel = row_rel_err(got, want)
            if q_dt == torch.bfloat16:
                assert rel <= BF16_ROW_RTOL, (kv_dt, rel)
                tol = {**tol, "row_rtol": BF16_ROW_RTOL}
            errs[(q_dt, kv_dt)] = err
            print(f"kernel vs plain: q {q_dt} pools {kv_dt}, variant {variant}: "
                  f"max |err| {err:.3e}, max row |err| / |ref| {rel:.3e} (tol {tol})")

    timings = {}
    for kind in ("decode", "mixed"):
        args = kernel_inputs(make_pack(kind), torch.bfloat16, torch.bfloat16, dev)
        call = lambda a=args: rpf.ragged_paged_flash(*a[:6])  # noqa: E731
        ms = cuda_ms(call)
        dev_ms = device_ms(call)
        plain = cuda_ms(lambda: rpf.ragged_paged_flash_ref(*args[:6]), iters=10)
        b_ms, b_by = bound(args)
        # cold: rotate over pool copies whose reached pages exceed the L2 twice
        kv_bytes = kv_reached(args[1], None, args[3], {
            b: int(args[5][args[4] == b].max()) for b in range(args[3].shape[0])
            if bool(((args[4] == b) & (args[5] > 0)).any())})[0]
        pools, n = cold_pools(args[1], args[2], kv_bytes)
        turn = itertools.count()

        def cold():
            kp, vp = pools[next(turn) % n]
            return rpf.ragged_paged_flash(args[0], kp, vp, *args[3:6])
        cold_ms = cuda_ms(cold, iters=4 * n)
        cold_dev = device_ms(cold, iters=2 * n)
        del pools
        timings[kind] = dict(ms=ms, device_ms=dev_ms, cold_ms=cold_ms,
                             cold_device_ms=cold_dev, plain_ms=plain,
                             bound_ms=b_ms, bound_by=b_by)
        print(f"ragged_paged_flash {kind} tick (T=256, bf16 q and pools, variant "
              f"{rpf.ragged_variant(torch.bfloat16, torch.bfloat16, 128)}) on "
              f"{card}: warm: events {ms:.4f} ms, device {fmt_ms(dev_ms)}; cold "
              f"({n} pool copies, {n * kv_bytes / 1e6:.0f} MB reached in turn): "
              f"events {cold_ms:.4f} ms, device {fmt_ms(cold_dev)}; plain "
              f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}), share of bound "
              f"{b_ms / ms:.3f} (events, warm); library call: none")
    return {"err": errs[(torch.bfloat16, torch.bfloat16)], "timings": timings,
            "shapes": check_kernel_shapes(card)}


# the serving kernel's head layouts of the served configs: glm4-9b (32
# query heads over 2 KV heads), qwen1.5-4b (20 heads, multi-head),
# llama4-maverick (40 over 8) and jamba (64 over 8)
SHAPES = {"glm4-9b": dict(kvH=2, G=16, hd=128), "qwen1.5-4b": dict(kvH=20, G=1, hd=128),
          "llama4-maverick": dict(kvH=8, G=5, hd=128),
          "jamba-1.5-large": dict(kvH=8, G=8, hd=128)}


def check_kernel_shapes(card: str) -> dict:
    """Kernel 1 at glm4-9b's, qwen1.5-4b's, llama4-maverick's (G 5) and
    jamba's (G 8) head layouts on the mixed pack, and at glm4-9b's on a
    verify pack (each slot's decode token, then its 4 draft tokens as a
    later run), bf16 q over bf16 and int8 pools,
    each through the "mma" variant, against the plain version with the
    tolerances of ``check_kernel``; the device time beside the byte bound."""
    from repro_torch.kernels import ragged_paged_flash as rpf

    dev = torch.device("cuda")
    out = {}
    cases = [("glm4-9b", "mixed"), ("qwen1.5-4b", "mixed"), ("glm4-9b", "verify"),
             ("llama4-maverick", "mixed"), ("jamba-1.5-large", "mixed")]
    for arch, kind in cases:
        pack = make_pack(kind, **SHAPES[arch])
        for kv_dt in (torch.bfloat16, torch.int8):
            args = kernel_inputs(pack, torch.bfloat16, kv_dt, dev)
            rpf.reset_launches()
            got = rpf.ragged_paged_flash(*args[:6], ks=args[6], vs=args[7])
            torch.cuda.synchronize()
            variant = ran(rpf.launches_by_variant)
            assert variant == "mma", (arch, kind, kv_dt, variant)
            want = rpf.ragged_paged_flash_ref(*args[:6], ks=args[6], vs=args[7])
            torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
            assert bool((got[args[5] == 0] == 0).all()), "lens == 0 rows must be zeros"
            rel = row_rel_err(got, want)
            assert rel <= BF16_ROW_RTOL, (arch, kind, kv_dt, rel)
            err = float((got.float() - want.float()).abs().max())
            del want
            call = lambda a=args: rpf.ragged_paged_flash(  # noqa: E731
                *a[:6], ks=a[6], vs=a[7])
            dev_ms = device_ms(call, iters=50)
            b_ms, b_by = bound(args)
            share = "not measured" if dev_ms is None else f"{b_ms / dev_ms:.4f}"
            T, kvH, G, hd = args[0].shape
            print(f"ragged_paged_flash {arch} (kvH {kvH}, G {G}, hd {hd}) {kind} "
                  f"pack, bf16 q, pools {kv_dt}, variant {variant}, on {card}: max "
                  f"|err| {err:.3e}, max row |err| / |ref| {rel:.3e} (tol atol 2e-2, "
                  f"row_rtol {BF16_ROW_RTOL}); device {fmt_ms(dev_ms)}, bound "
                  f"{b_ms:.5f} ms ({b_by}), share of bound {share} (device)")
            out[(arch, kind, str(kv_dt))] = dict(err=err, device_ms=dev_ms,
                                                 bound_ms=b_ms, bound_by=b_by)
            del args, got
        torch.cuda.empty_cache()
    return out


# gemma3-4b's head layout (8 query heads over 4 KV heads, head_dim 256),
# which its 5 global layers give both serving kernels: the "simt" variant
GEMMA3_HEADS = dict(kvH=4, G=2, hd=256)


def check_gemma3_kernels(card: str) -> dict:
    """Kernels 1 and 2 at gemma3-4b's head layout (``GEMMA3_HEADS``): kernel
    1 on the mixed pack of ``check_kernel``, kernel 2 on the decode tick of
    ``check_decode``, bf16 q over bf16 and int8 pools, each through the
    "simt" variant, against their plain versions with ``check_kernel``'s
    tolerances; the device time (``device_ms``) beside the bound, and the
    plain version's CUDA-event time."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import ragged_paged_flash as rpf

    dev = torch.device("cuda")
    b16 = torch.bfloat16
    out = {}
    cases = (("ragged_paged_flash", rpf, make_pack("mixed", **GEMMA3_HEADS),
              bound),
             ("paged_flash_decode", pfd, make_decode_pack(**GEMMA3_HEADS),
              decode_bound))
    for name, mod, pack, bnd in cases:
        for kv_dt in (b16, torch.int8):
            args = kernel_inputs(pack, b16, kv_dt, dev)
            *index, ks, vs = args
            kernel = getattr(mod, name)
            plain = getattr(mod, name + "_ref")
            call = lambda: kernel(*index, ks=ks, vs=vs)  # noqa: E731
            mod.reset_launches()
            got = call()
            torch.cuda.synchronize()
            variant = ran(mod.launches_by_variant)
            assert variant == "simt", (name, kv_dt, variant)
            want = plain(*index, ks=ks, vs=vs)
            torch.testing.assert_close(got.float(), want.float(), rtol=0.0,
                                       atol=2e-2)
            lens = index[-1]
            assert bool((got[lens == 0] == 0).all()), "lens == 0 rows must be zeros"
            rel = row_rel_err(got, want)
            assert rel <= BF16_ROW_RTOL, (name, kv_dt, rel)
            err = float((got.float() - want.float()).abs().max())
            del want, got
            dev_ms = device_ms(call, iters=50)
            plain_ms = cuda_ms(lambda: plain(*index, ks=ks, vs=vs), iters=5,
                               warmup=1)
            b_ms, b_by = bnd(args)
            share = "not measured" if dev_ms is None else f"{b_ms / dev_ms:.4f}"
            what = "mixed pack (T=256)" if mod is rpf else "decode tick (B=8)"
            print(f"{name} at gemma3-4b's heads (kvH 4, G 2, hd 256), {what}, "
                  f"bf16 q, pools {kv_dt}, variant {variant}, on {card}: max "
                  f"|err| {err:.3e}, max row |err| / |ref| {rel:.3e} (tol atol "
                  f"2e-2, row_rtol {BF16_ROW_RTOL}); device {fmt_ms(dev_ms)}, "
                  f"bound {b_ms:.5f} ms ({b_by}), share of bound {share} "
                  f"(device); plain {plain_ms:.4f} ms (events); library call: "
                  f"none")
            out[(name, str(kv_dt))] = dict(err=err, device_ms=dev_ms,
                                           plain_ms=plain_ms, bound_ms=b_ms,
                                           bound_by=b_by)
            del args, index, ks, vs
            torch.cuda.empty_cache()
    return out


def make_decode_pack(*, B=8, kvH=2, G=6, hd=128, page=16, cache_len=2048,
                     seed=0):
    """Phase 4's decode tick as the two-phase engine builds it: one token
    per slot at lens up to cache_len, slot 7 empty; each slot maps only the
    pages its lens reach, the rest of its block-table row is the sentinel
    ``n_pages``.  float32 q and pools and int32 index tensors, on the CPU."""
    rng = np.random.RandomState(seed)
    pps = cache_len // page
    n_pages = B * pps
    lens = np.asarray([cache_len, 1500, 1101, 701, 421, 201, 65, 0][:B], np.int32)
    perm = rng.permutation(n_pages)
    ptab = np.full((B, pps), n_pages, np.int32)
    for b in range(B):
        used = -(-int(lens[b]) // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    normal = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    return (normal(B, kvH, G, hd), normal(n_pages, page, kvH, hd),
            normal(n_pages, page, kvH, hd), torch.from_numpy(ptab),
            torch.from_numpy(lens))


def decode_bound(args) -> tuple:
    """(ms, "bytes" | "operations") of one decode tick: the KV pages and
    scale rows the live lens reach, the live slots' q rows, the used
    block-table entries and every slot's lens read once, the whole output
    written once; FLOPs 4 * sum(lens) * G * kvH * hd."""
    q, kp, vp, ptab, lens, ks, vs = args
    B, kvH, G, hd = q.shape
    lens_c = lens.cpu().numpy()
    kv_bytes, entries = kv_reached(kp, ks, ptab, {
        b: int(lens_c[b]) for b in np.nonzero(lens_c > 0)[0]})
    row = kvH * G * hd * q.element_size()
    nbytes = (kv_bytes + int((lens_c > 0).sum()) * row + B * row + B * 4
              + entries * 4)
    return roof(nbytes, 4.0 * float(lens_c.sum()) * G * kvH * hd, q.dtype)


def roof(nbytes, flops, dtype) -> tuple:
    """The larger of bytes over the HBM rate and FLOPs over the type's
    peak, in ms, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# bf16 outputs of the attention kernels: each output row (hd values) within
# this share of its norm, about 2.5 bf16 rounding units (2^-8)
BF16_ROW_RTOL = 1e-2


def row_rel_err(got, want) -> float:
    """Largest |got - want| / |want| over the output rows (the last axis,
    hd values), both taken in float32; an all-zero row of both counts 0."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def cold_pools(kp, vp, kv_bytes):
    """Copies of the pools to rotate over, so that the pages the calls
    reach in turn exceed the 50 MB L2 twice: (copies, their count)."""
    n = -(-2 * L2_BYTES // kv_bytes) + 1
    return [(kp.clone(), vp.clone()) for _ in range(n)], n


def check_decode(card: str) -> dict:
    """Kernel 2 against its plain version at phase 4's decode tick, every
    (q, pool) type pair, each through the variant ``kernel_variant`` names.
    A bf16 output is held twice: each element to atol 2e-2, and each output
    row (one slot, KV head and query head) to BF16_ROW_RTOL of its norm.  A
    slot of length L averages about L/e keys, so |o| is near 0.036 in the
    2048-token slot: only the row bound sees an error in proportion to it.
    Then, at bf16: the device time (``device_ms``) and CUDA-event time of
    the kernel at split sizes of 64, 128 and 256 keys, warm and cold; the
    plain version's time; and ``ragged_paged_flash`` on the same pack as a
    ragged pack of one token per slot (``slot = arange(B)``), the kernel
    that computes the same function."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import ragged_paged_flash as rpf

    dev = torch.device("cuda")
    pack = make_decode_pack()
    errs = {}
    for q_dt in (torch.float32, torch.bfloat16):
        for kv_dt in (torch.float32, torch.bfloat16, torch.int8):
            q, kp, vp, ptab, lens, ks, vs = kernel_inputs(pack, q_dt, kv_dt, dev)
            pfd.reset_launches()
            got = pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)
            torch.cuda.synchronize()
            variant = ran(pfd.launches_by_variant)
            assert variant == pfd.kernel_variant(q, kp, vp), (q_dt, kv_dt, variant)
            want = pfd.paged_flash_decode_ref(q, kp, vp, ptab, lens, ks=ks, vs=vs)
            tol = (dict(rtol=1e-4, atol=1e-4) if q_dt == torch.float32
                   else dict(rtol=0.0, atol=2e-2))
            torch.testing.assert_close(got.float(), want.float(), **tol)
            assert bool((got[lens == 0] == 0).all()), "lens == 0 slots must be zeros"
            err = float((got.float() - want.float()).abs().max())
            rel = row_rel_err(got, want)
            if q_dt == torch.bfloat16:
                assert rel <= BF16_ROW_RTOL, (kv_dt, rel)
                tol = {**tol, "row_rtol": BF16_ROW_RTOL}
            errs[(q_dt, kv_dt)] = err
            live = want[lens > 0].float().abs()
            print(f"paged_flash_decode vs plain: q {q_dt} pools {kv_dt}, variant "
                  f"{variant}: max |err| {err:.3e}, max row |err| / |ref| "
                  f"{rel:.3e}, median |ref| {float(live.median()):.3e} (tol {tol})")

    out = {"err": errs[(torch.bfloat16, torch.bfloat16)], "library_ms": None}
    b16 = torch.bfloat16
    for kv_dt in (b16, torch.int8):
        args = kernel_inputs(pack, b16, kv_dt, dev)
        q, kp, vp, ptab, lens, ks, vs = args
        variant = pfd.kernel_variant(q, kp, vp)
        b_ms, b_by = decode_bound(args)
        kv_bytes = kv_reached(kp, ks, ptab, {
            b: int(n) for b, n in enumerate(lens.tolist()) if n > 0})[0]
        pools, n = cold_pools(kp, vp, kv_bytes)
        turn = itertools.count()

        def cold():
            kpc, vpc = pools[next(turn) % n]
            return pfd.paged_flash_decode(q, kpc, vpc, ptab, lens, ks=ks, vs=vs)

        def call():
            return pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)

        default = pfd.SPLIT_KEYS
        want = pfd.paged_flash_decode_ref(q, kp, vp, ptab, lens, ks=ks, vs=vs)
        for keys in (64, 128, 256):
            pfd.SPLIT_KEYS = keys
            try:
                got = call()
                torch.testing.assert_close(got.float(), want.float(), rtol=0.0,
                                           atol=2e-2)
                assert row_rel_err(got, want) <= BF16_ROW_RTOL, keys
                splits = pfd.n_splits(ptab.shape[1] * kp.shape[1])
                ms, dev_ms = cuda_ms(call), device_ms(call, iters=50)
                cold_ms = cuda_ms(cold, iters=4 * n)
                cold_dev = device_ms(cold, iters=2 * n)
            finally:
                pfd.SPLIT_KEYS = default
            print(f"paged_flash_decode decode tick (B=8, lens up to 2048, bf16 q, "
                  f"pools {kv_dt}, variant {variant}, {keys}-key splits, {splits} "
                  f"a row) on {card}: warm: events {ms:.4f} ms, device "
                  f"{fmt_ms(dev_ms)}; cold ({n} pool copies, {n * kv_bytes / 1e6:.0f} "
                  f"MB reached in turn): events {cold_ms:.4f} ms, device "
                  f"{fmt_ms(cold_dev)}; bound {b_ms:.5f} ms ({b_by})")
            if kv_dt == b16 and keys == default:
                out.update(ms=ms, device_ms=dev_ms, cold_ms=cold_ms,
                           cold_device_ms=cold_dev, bound_ms=b_ms, bound_by=b_by)
        del pools
        plain = cuda_ms(lambda: pfd.paged_flash_decode_ref(
            q, kp, vp, ptab, lens, ks=ks, vs=vs), iters=10)
        slot = torch.arange(q.shape[0], dtype=torch.int32, device=dev)
        ragged = lambda: rpf.ragged_paged_flash(  # noqa: E731
            q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
        diff = float((ragged().float() - call().float()).abs().max())
        r_ms, r_dev = cuda_ms(ragged), device_ms(ragged, iters=50)
        print(f"  same pack, pools {kv_dt}: plain {plain:.4f} ms (events); "
              f"ragged_paged_flash with slot = arange(B): events {r_ms:.4f} ms, "
              f"device {fmt_ms(r_dev)} (max |diff| to the decode kernel "
              f"{diff:.3e}); library call: none")
        if kv_dt == b16:
            out.update(plain_ms=plain, ragged_ms=r_ms, ragged_device_ms=r_dev)
    dm = out["device_ms"]
    share = "not measured" if dm is None else f"{out['bound_ms'] / dm:.4f}"
    print(f"paged_flash_decode at {pfd.SPLIT_KEYS}-key splits on {card}: device "
          f"{fmt_ms(dm)}, share of bound {share} (device), plain / kernel "
          f"(events) {out['plain_ms'] / out['ms']:.1f}")
    return out


def matmul_bound(M, K, N, dtype, block, accum) -> tuple:
    """``matmul.policy_bytes`` over the HBM rate or 2 M N K FLOPs over the
    peak of the inputs' type, whichever is larger."""
    from repro_torch.kernels import matmul as mm

    return roof(mm.policy_bytes(M, K, N, dtype, block, accum),
                2.0 * M * N * K, dtype)


def check_matmul(card: str) -> dict:
    """Kernel 5 against its plain version and torch.matmul (TF32 off), both
    policies, float32 and bfloat16, at 4096^3 (a sweep point) and a shape
    that needs padding on the TPU (1000 x 1500 x 700).  Tolerance: float32
    rtol 1e-4, bfloat16 one bf16 rounding unit (rtol 2^-7: both sides round
    one float32 sum), each with an atol that scales with sqrt(K) x rms|a| x
    rms|b|: 2^-16 (float32) and 2^-12 (bfloat16) of it."""
    from repro_torch.kernels import matmul as mm

    out = {}
    block = (256, 256, 256)
    for M, K, N in ((4096, 4096, 4096), (1000, 1500, 700)):
        g = torch.Generator("cuda").manual_seed(M + K + N)
        a32 = torch.randn((M, K), generator=g, device="cuda")
        b32 = torch.randn((K, N), generator=g, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            a, b = a32.to(dt), b32.to(dt)
            spread = math.sqrt(K) * float(a.float().pow(2).mean().sqrt()) * float(
                b.float().pow(2).mean().sqrt())
            tol = (dict(rtol=1e-4, atol=2 ** -16 * spread) if dt == torch.float32
                   else dict(rtol=2 ** -7, atol=2 ** -12 * spread))
            want = mm.matmul_ref(a, b)
            for accum in mm.ACCUMS:
                mm.reset_launches()
                got = mm.matmul(a, b, block=block, accum=accum)
                torch.cuda.synchronize()
                route = ran(mm.launches_by_route)
                assert route == mm.matmul_route(dt, K, N), (M, dt, accum, route)
                torch.testing.assert_close(got.float(), want.float(), **tol)
                err = float((got.float() - want.float()).abs().max())
                kernel_fn = lambda: mm.matmul(a, b, block=block, accum=accum)  # noqa: E731
                ms = cuda_ms(kernel_fn, iters=5, warmup=1)
                dev_ms = device_ms(kernel_fn, iters=5, warmup=1)
                plain = cuda_ms(lambda: mm.matmul_ref(a, b), iters=5, warmup=1)
                lib = cuda_ms(lambda: torch.matmul(a, b), iters=5, warmup=1)
                b_ms, b_by = matmul_bound(M, K, N, dt, block, accum)
                passes = mm.k_passes(K, block, accum)
                moved = mm.policy_bytes(M, K, N, dt, block, accum)
                print(f"matmul {M}x{K}x{N} {dt} accum {accum} ({passes} C "
                      f"passes, {moved / 1e9:.3f} GB to move), route {route}, "
                      f"on {card}: max "
                      f"|err| {err:.3e} (tol "
                      f"rtol {tol['rtol']:.3g}, atol {tol['atol']:.3g}); kernel "
                      f"{ms:.4f} ms = {2e-9 * M * N * K / ms:.1f} TFLOP/s (events),"
                      f" device {fmt_ms(dev_ms)}, plain "
                      f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound "
                      f"{b_ms:.5f} ms ({b_by}), share of bound {b_ms / ms:.4f}, "
                      f"kernel / library {ms / lib:.2f}")
                out[(M, dt, accum)] = dict(err=err, ms=ms, device_ms=dev_ms,
                                           plain_ms=plain,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=lib)
            del a, b, want
        del a32, b32
    return out


def check_rmsnorm(card: str) -> dict:
    """Kernel 4 against its plain version and torch.nn.functional.rms_norm
    at the serving pack (256 x 1536) and the training activations (8192 x
    1536), float32 and bfloat16.  Tolerance: float32 rtol = atol = 1e-5;
    bfloat16 one rounding unit (rtol 2^-7) with atol 1e-5.  The library
    call gets the scale in x's type (its fused path); the kernel is held
    against it with that scale rounded the same way."""
    from repro_torch.kernels import rmsnorm as rn

    out = {}
    for R in (256, 8192):
        g = torch.Generator("cuda").manual_seed(R)
        x32 = torch.randn((R, 1536), generator=g, device="cuda")
        scale = torch.randn(1536, generator=g, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            tol = (dict(rtol=1e-5, atol=1e-5) if dt == torch.float32
                   else dict(rtol=2 ** -7, atol=1e-5))
            got = rn.rmsnorm(x, scale)
            torch.cuda.synchronize()
            want = rn.rmsnorm_ref(x, scale)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            s_lib = scale.to(dt)
            lib_fn = lambda: torch.nn.functional.rms_norm(  # noqa: E731
                x, (1536,), s_lib, 1e-6)
            torch.testing.assert_close(rn.rmsnorm(x, s_lib.float()).float(),
                                       lib_fn().float(), **tol)
            err = float((got.float() - want.float()).abs().max())
            route = rn.rmsnorm_plan(R, 1536, x.element_size())
            kernel_fn = lambda: rn.rmsnorm(x, scale)  # noqa: E731
            ms = cuda_ms(kernel_fn, iters=50)
            dev_ms = device_ms(kernel_fn, iters=50)
            plain = cuda_ms(lambda: rn.rmsnorm_ref(x, scale), iters=20)
            lib = cuda_ms(lib_fn, iters=50)
            lib_dev = device_ms(lib_fn, iters=50)
            nbytes = 2 * x.numel() * x.element_size() + 1536 * 4
            b_ms, b_by = roof(nbytes, 4.0 * x.numel(), dt)
            share = "not measured" if dev_ms is None else f"{b_ms / dev_ms:.4f}"
            print(f"rmsnorm ({R}, 1536) {dt}, route {route[0]} with {route[1]} "
                  f"threads a row, on {card}: max |err| {err:.3e} (tol {tol}); "
                  f"kernel: events {ms:.4f} ms, device {fmt_ms(dev_ms)}; "
                  f"F.rms_norm: events {lib:.4f} ms, device {fmt_ms(lib_dev)}; "
                  f"plain {plain:.4f} ms; bound {b_ms:.5f} ms ({b_by}), share "
                  f"of bound {share} (device)")
            out[(R, dt)] = dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                                library_device_ms=lib_dev)
    return out


def rmsnorm_route(card: str) -> int:
    """The norm layer's kernel route (``norms.rmsnorm(use_kernel=True)``,
    which no model path sets, as in JAX) at the serving pack and the
    training activations in bf16: launches counted from 0, the result
    equal to the plain route."""
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.layers import norms

    params = {"scale": torch.ones(1536, device="cuda")}
    xs = [torch.randn((R, 1536), device="cuda").bfloat16() for R in (256, 8192)]
    rn.launches = 0
    outs = [norms.rmsnorm(params, x, 1e-6, use_kernel=True) for x in xs]
    torch.cuda.synchronize()
    launches = rn.launches
    for x, o in zip(xs, outs):
        torch.testing.assert_close(o.float(), norms.rmsnorm(params, x, 1e-6).float(),
                                   rtol=2 ** -7, atol=1e-5)
    assert launches == len(xs), launches
    print(f"norm layer kernel route on {card}: {launches} launches, equal to "
          f"the plain route")
    return launches


# gemma3-4b's global layers at batch 1, sequence 4096: 8 query heads over 4
# KV heads at head_dim 256 (the "simt" variant)
GEMMA_FLASH = dict(BH=8, BKV=4, S=4096, hd=256)


def flash_inputs(BH, BKV, S, hd, dtype, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((BH, S, hd), (BKV, S, hd), (BKV, S, hd))]


def flash_flops(q, window=None) -> float:
    """4 * hd FLOPs for each (row, col) pair the mask keeps — 0 <= row - col
    < window (S without one) — in each of the BH rows."""
    BH, S, hd = q.shape
    W = S if window is None else min(window, S)
    pairs = W * S - W * (W - 1) // 2
    return 4.0 * hd * pairs * BH


def flash_bound(q, k, window=None) -> tuple:
    """(ms, "bytes" | "operations"): q, k and v read once and the output
    written once; ``flash_flops`` at the peak rate of the inputs' type."""
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return roof(nbytes, flash_flops(q, window), q.dtype)


def ran(counts: dict) -> str:
    """The one variant or route a per-variant launch count shows ran
    (several, joined by "+", if more than one did)."""
    return "+".join(k for k, n in counts.items() if n) or "none"


def check_flash(card: str) -> dict:
    """The kernel against its plain version.  bf16 is held twice: each
    element to atol 2e-2, and each output row to BF16_ROW_RTOL of the
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
    cases += [("gemma3 global", GEMMA_FLASH, dt, window, 128)
              for dt in (torch.float32, torch.bfloat16) for window in (None, 512)]
    errs = {}
    for name, shape, dt, window, blk in cases:
        q, k, v = flash_inputs(**shape, dtype=dt)
        fa.reset_launches()
        got = fa.flash_attention(q, k, v, bq=blk, bk=blk, window=window)
        torch.cuda.synchronize()
        variant = ran(fa.launches_by_variant)
        assert variant == fa.flash_variant(dt, q.shape[-1]), (name, dt, variant)
        want = fa.flash_attention_ref(q, k, v, window)
        tol = (dict(rtol=1e-4, atol=1e-4) if dt == torch.float32
               else dict(rtol=0.0, atol=2e-2))
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = float((got.float() - want.float()).abs().max())
        rel = row_rel_err(got, want)
        if dt == torch.bfloat16:
            assert rel <= BF16_ROW_RTOL, (name, rel)
            tol = {**tol, "row_rtol": BF16_ROW_RTOL}
        errs[(name, dt)] = err
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, bq=blk, bk=blk,
                                                window=window),
                     iters=10, warmup=2)
        print(f"flash_attention vs plain: {name} {tuple(q.shape)} over "
              f"{tuple(k.shape)} {dt} window {window}, variant {variant}, "
              f"{ms:.4f} ms = {flash_flops(q, window) / ms / 1e9:.1f} "
              f"TFLOP/s: max |err| {err:.3e}, "
              f"max row |err| / |ref| {rel:.3e}, median |ref| "
              f"{float(want.float().abs().median()):.3e} (tol {tol})")
        del q, k, v, got, want

    out = {"err": errs[("main", torch.bfloat16)]}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(**main, dtype=dt)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters=20, warmup=3)
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v), iters=10)
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
        tflops = flash_flops(q) / ms / 1e9
        print(f"flash_attention at the training shape {tuple(q.shape)} {dt}, "
              f"variant {fa.flash_variant(dt, q.shape[-1])}, on {card}: kernel "
              f"{ms:.4f} ms = {tflops:.1f} TFLOP/s (events), device "
              f"{fmt_ms(dev_ms)}, plain {plain:.4f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms (max |diff| to the "
              f"kernel {diff:.3e}), bound {b_ms:.5f} ms ({b_by}), share of "
              f"bound {b_ms / ms:.4f}, kernel / library {ms / lib:.2f}")
        if dt == torch.bfloat16:
            out.update(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib)
        del q, k, v, q4, k4, v4
    out["gemma"] = flash_gemma_times(card)
    out["vision"] = flash_vision_times(card)
    return out


# llama-3.2-vision-11b's self-attention layers at batch 1, sequence 4096: 32
# query heads over 8 KV heads at head_dim 128 (G 4, the "wgmma" variant)
VISION_FLASH = dict(BH=32, BKV=8, S=4096, hd=128)


def flash_vision_times(card: str) -> dict:
    """The kernel at llama-3.2-vision's shape, bf16, causal: held against
    its plain version (atol 2e-2 and each row within BF16_ROW_RTOL of its
    norm), then device and event times beside the plain version, SDPA and
    the operation bound."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(**VISION_FLASH, dtype=torch.bfloat16, seed=1)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    variant = ran(fa.launches_by_variant)
    assert variant == "wgmma", fa.launches_by_variant
    want = fa.flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
    err = float((got.float() - want.float()).abs().max())
    rel = row_rel_err(got, want)
    assert rel <= BF16_ROW_RTOL, rel
    del got, want
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters=20, warmup=3)
    dev_ms = device_ms(lambda: fa.flash_attention(q, k, v), iters=10)
    plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), iters=3, warmup=1)
    q4 = q.view(1, 32, 4096, 128)
    k4, v4 = (t.view(1, 8, 4096, 128) for t in (k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, is_causal=True, enable_gqa=True)
    lib = cuda_ms(sdpa, iters=20, warmup=3)
    lib_dev = device_ms(sdpa, iters=10)
    b_ms, b_by = flash_bound(q, k)
    print(f"flash_attention at llama-3.2-vision-11b's self-attention shape "
          f"{tuple(q.shape)} over {tuple(k.shape)} (G 4) bf16 causal, variant "
          f"{variant}, on {card}: max |err| {err:.3e}, max row |err| / |ref| "
          f"{rel:.3e} (tol atol 2e-2, row {BF16_ROW_RTOL}); kernel device "
          f"{fmt_ms(dev_ms)} (events {ms:.4f} ms = "
          f"{flash_flops(q) / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
          f"scaled_dot_product_attention {lib:.4f} ms (device "
          f"{fmt_ms(lib_dev)}), bound {b_ms:.5f} ms ({b_by}, "
          f"{flash_flops(q) / 1e9:.1f} GFLOP), share of bound "
          f"{b_ms / ms:.4f}, kernel / library {ms / lib:.2f}")
    del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    return dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by)


def flash_gemma_times(card: str) -> dict:
    """Device and event times of the kernel at gemma3's global shape, f32
    and bf16, causal, beside its plain version, SDPA and the operation
    bound; {dtype name: {"device_ms", "ms", "plain_ms", "library_ms",
    "bound_ms"}}."""
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(**GEMMA_FLASH, dtype=dt)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters=10, warmup=2)
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v), iters=5)
        plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), iters=3,
                        warmup=1)
        q4 = q.view(1, 8, 4096, 256)
        k4, v4 = (t.view(1, 4, 4096, 256) for t in (k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True, enable_gqa=True)
        lib = cuda_ms(sdpa, iters=10, warmup=2)
        b_ms, b_by = flash_bound(q, k)
        name = str(dt).split(".")[-1]
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        print(f"flash_attention at gemma3-4b's global shape {tuple(q.shape)} "
              f"over {tuple(k.shape)} {dt}, variant "
              f"{fa.flash_variant(dt, 256)}, on {card}: kernel device "
              f"{fmt_ms(dev_ms)} (events {ms:.4f} ms = "
              f"{flash_flops(q) / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} "
              f"ms, scaled_dot_product_attention {lib:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), share of bound {b_ms / ms:.4f}, "
              f"kernel / library {ms / lib:.2f}")
        del q, k, v, q4, k4, v4
    return out


# ---------------------------------------------------------------------------
# 4. full-width serving


def _device_us(evt) -> float:
    """Device self time of a profiler event, in µs, across torch versions."""
    t = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if t is None else t


# the CUDA functions of each serving wrapper's launch: the ragged kernel's
# plan, attention (either variant) and merge kernels; the decode kernel's
# one kernel (either variant)
SERVE_KERNELS = {
    "ragged_paged_flash": ("ragged_plan_kernel", "ragged_mma_kernel",
                           "ragged_simt_kernel", "ragged_merge_kernel"),
    "paged_flash_decode": ("decode_mma_kernel", "decode_simt_kernel"),
}
# the attention kernel of each wrapper's "mma" variant: one instance per
# launch, so a profiled run's instances count the launches that ran, graph
# replays included
MMA_KERNELS = {"ragged_paged_flash": "ragged_mma_kernel",
               "paged_flash_decode": "decode_mma_kernel"}
# host ranges of a tick (record_function names, wrapped around the engine's
# methods by serve_full): the whole tick, then its parts
HOST_RANGES = ("engine.tick", "engine.admit", "engine.pack", "engine.step",
               "engine.logits_copy", "engine.sample")


def _ranged(name, fn):
    def run(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return run


# depth cuts that keep the script's time: phase 4's ragged path (and phase
# 4c) at half of qwen2-1.5b's 28 layers, its two-phase path at a quarter
# (each at 28 and 14 before the xLSTM phases came in), phase 4b at half of
# glm4-9b's 40
SERVE_LAYERS = 14
TWO_PHASE_LAYERS = 7
SPEC_LAYERS = 20


def cut_depth(cfg, layers: int):
    """``cfg``'s one-stage pattern cut to ``layers`` repeats."""
    from repro_torch.configs import Stage

    return cfg.replace(stages=(Stage(cfg.stages[0].pattern, layers),))


class RecordsLost(AssertionError):
    """A profiled run recorded fewer kernel instances than were launched."""


def serve_full(params, cfg, kv_dtype, card: str, *, ragged: bool = True,
               captured: bool = True, profile=None) -> dict:
    """Serve the phase-4 workload once, through the ragged engine or, with
    ``ragged=False``, the two-phase engine (prefill chunks, then decode
    ticks through the paged flash-decode kernel); with ``captured`` each
    step replays its CUDA graph, else it runs eagerly (``cuda_graph=False``).

    The eager arm brackets every kernel launch with CUDA events (never
    recorded into a graph: the captured arm has none).  ``profile`` traces
    the run with ``torch.profiler``: "cuda" (one profiler cycle per tick,
    each tick waited on) sums the device time of every kernel and counts
    the serving kernel's attention-kernel instances, which must equal the
    engine's launches — under replay the proof that the graph ran the
    kernels (a short count raises ``RecordsLost``).  "cpu" times the host ranges of ``HOST_RANGES`` per tick.  Returns the numbers and the transcripts."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import ragged_paged_flash as rpf
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.RandomState(1)
    kmod, kname = (rpf, "ragged_paged_flash") if ragged else (pfd, "paged_flash_decode")
    kmod.reset_launches()
    eng = ServeEngine(params, cfg, batch_size=8, cache_len=2048, page_size=16,
                      prefill_chunk=128, token_budget=256, flash_decode=True,
                      kv_dtype=kv_dtype, ragged=ragged, device=params.device,
                      cuda_graph=captured)
    ptrs = [t.data_ptr() for t in eng.pool_tensors()]  # builds the steps
    steps = ([eng._ragged_step] if ragged
             else [eng._chunk_step, eng._decode_step])
    st = eng.stats
    assert all(s.captured == captured for s in steps), "capture state"
    assert st["graph_captures"] == (len(steps) if captured else 0), st
    # while capturing, the wrapper's own counts saw only the warm-up and the
    # capture: every one of those launches took the tensor-core variant
    assert kmod.launches_by_variant["mma"] == kmod.launches, \
        kmod.launches_by_variant

    sample = eng._sample

    def checked_sample(req, row, ordinal):
        assert math.isfinite(row.min()) and math.isfinite(row.max()), \
            "non-finite logits"
        return sample(req, row, ordinal)

    eng._sample = checked_sample
    if profile == "cpu":
        eng.tick = _ranged("engine.tick", eng.tick)
        eng._admit_round = _ranged("engine.admit", eng._admit_round)
        for name in ("_pack_ragged", "_pack_prefill", "_pack_decode"):
            setattr(eng, name, _ranged("engine.pack", getattr(eng, name)))
        for s in steps:
            s.run = _ranged("engine.step", s.run)
            s.fetch = _ranged("engine.logits_copy", s.fetch)
        eng._sample = _ranged("engine.sample", eng._sample)
    spans = []  # (start, end) CUDA events around each eager kernel launch
    kernel = getattr(kmod, kname)

    def timed_kernel(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = kernel(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    prefix = rng.randint(0, cfg.vocab_size, 300)
    prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 40)])]
    prompts += [rng.randint(0, cfg.vocab_size, n)
                for n in (32, 700, 450, 96, 260, 610)]
    if profile == "cuda":
        prof = tick_profiler(eng)
    elif profile == "cpu":
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    else:
        prof = contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kmod.reset_launches()
    if not captured:
        setattr(kmod, kname, timed_kernel)
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
        setattr(kmod, kname, kernel)
    st = eng.stats
    assert all(len(results[h]) == 32 for h in handles), \
        {int(h): len(results[h]) for h in handles}
    assert st["traces"] == (1 if ragged else 0), st
    assert st["prefix_hits"] >= 1 and st["cow_copies"] >= 1, st
    kernel_ticks = st["ragged_ticks"] if ragged else st["decode_ticks"]
    launches = st["kernel_launches"]
    assert launches == cfg.n_layers * kernel_ticks, st
    if captured:  # replays run no wrapper code
        assert kmod.launches == 0 and not spans, (kmod.launches, len(spans))
    else:
        assert len(spans) == launches == kmod.launches, (len(spans), st)
        # bf16 activations over bf16 or int8 pools: the tensor cores
        assert kmod.launches_by_variant["mma"] == launches, \
            kmod.launches_by_variant
    assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs, "pools moved"
    assert eng.pool.pages_in_use == 0 and eng.reclaimable_pages == eng.n_pages
    toks = sum(len(results[h]) for h in handles)
    ticks = st["ticks"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    arm = "captured" if captured else "eager"
    tag = f", profiled ({profile})" if profile else ""
    kind = ("ragged" if ragged else
            f"two-phase ({st['chunk_ticks']} prefill, {st['decode_ticks']} decode ticks)")
    print(f"serve {cfg.name} FULL width ({cfg.n_layers} layers), {kind}, pools "
          f"{kv_dtype or 'bfloat16'}, {arm}{tag}, on {card}: {len(handles)} "
          f"requests, {toks} tokens in {wall:.3f} s = {toks / wall:.1f} "
          f"tokens/s, {ticks} ticks, {1e3 * wall / ticks:.2f} ms/tick, peak "
          f"memory {peak:.2f} GiB, prefix hits {st['prefix_hits']}, COW copies "
          f"{st['cow_copies']}, kernel launches {launches} "
          f"({cfg.n_layers} x {kernel_ticks} kernel ticks), graphs captured "
          f"{st['graph_captures']}")
    out = dict(wall_ms=1e3 * wall, ticks=ticks, tokens=toks, busy_ms=None,
               launches=launches, kernel_ticks=kernel_ticks,
               decode_ticks=st["decode_ticks"],
               transcripts=[list(results[h]) for h in handles])
    if spans:
        kernel_ms = sum(a.elapsed_time(b) for a, b in spans)
        out["kernel_ms"] = kernel_ms
        print(f"  {kname} kernel in this run (CUDA events): {kernel_ms:.3f} ms "
              f"over {len(spans)} launches = {kernel_ms / len(spans):.4f} ms "
              f"per launch, {kernel_ms / ticks:.3f} ms per tick, "
              f"{kernel_ms / (1e3 * wall):.3f} of the wall time")
    if profile == "cuda":
        out.update(tally_profile(prof, kname, cfg, launches, kernel_ticks, ticks,
                                 wall, arm))
    elif profile == "cpu":
        host = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                if e.key in HOST_RANGES}
        out["host_ms"] = {k: host.get(k, 0.0) / ticks for k in HOST_RANGES}
        parts = sum(out["host_ms"][k] for k in HOST_RANGES[1:])
        print("  host ms per tick (profiler, CPU activity): " + ", ".join(
            f"{k.split('.')[1]} {out['host_ms'][k]:.3f}" for k in HOST_RANGES)
            + f", other {out['host_ms']['engine.tick'] - parts:.3f}")
    return out


def tally_profile(prof, kname, cfg, launches, kernel_ticks, ticks, wall,
                  arm, *, instances=None, per_tick=None) -> dict:
    """A CUDA-profiled serving run's numbers: device busy time, the top
    kernels, and the serving kernel's attention-kernel instances
    (``instances``: the "mma" variant's kernel unless named), which must
    equal the engine's ``launches``, ``per_tick`` (all layers unless given)
    a kernel tick (fewer raises ``RecordsLost``, more or none fails).
    Returns {"busy_ms", "kernel_device_ms", "kernels"} (``kernels``: every
    kernel and copy instance recorded), empty when the profiler recorded
    no device time."""
    instances = instances or MMA_KERNELS[kname]
    per_tick = per_tick or cfg.n_layers
    by_name, count = {}, {}
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            count[e.key] = count.get(e.key, 0) + e.count
    busy = sum(by_name.values())
    if busy == 0:
        print("  profiler: no device time recorded (not measured)")
        return {}
    print(f"  profiler: device busy {busy:.3f} ms = {busy / ticks:.3f} "
          f"ms per tick, {busy / (1e3 * wall):.3f} of this run's wall "
          f"time; top kernels by device time:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.3f} ms  {ms / busy:.3f}  {name[:110]}")
    mma = sum(n for name, n in count.items() if instances in name)
    if mma == 0:
        raise AssertionError(
            f"the profiler recorded {busy:.3f} ms of device time but no "
            f"{instances} instance: it does not break the {arm} "
            f"run down into its kernels, so the run cannot show that the "
            f"serving kernel ran")
    if mma < launches:
        raise RecordsLost(f"the profiler recorded {mma} of {launches} "
                          f"{instances} instances ({arm} arm)")
    assert mma == launches, (f"{instances} ran {mma} times, "
                             f"the engine counted {launches} launches")
    k_ms = sum(ms for name, ms in by_name.items()
               if any(k in name for k in SERVE_KERNELS[kname]))
    print(f"  {kname}: {mma} {instances} instances "
          f"({per_tick} x {kernel_ticks} kernel ticks = {launches}); "
          f"device time "
          f"(profiler, all its kernels) {k_ms:.3f} ms = "
          f"{k_ms / launches:.4f} ms per launch, {k_ms / busy:.3f} of the "
          f"busy time")
    return {"busy_ms": busy, "kernel_device_ms": k_ms,
            "kernels": sum(count.values())}


# host time on each side of a profiled tick, inside its profiler window
PROFILE_PAD_S = 0.005


def tick_profiler(eng, on_trace_ready=None):
    """A CUDA-activity profiler with one cycle per engine tick (each tick
    waited on), wrapped around ``eng.tick``: in one long session the
    profiler now and then lost kernel records, of graph replays and of
    eager launches alike; per-tick cycles lose fewer, but not none, so a
    run that lost some raises RecordsLost and serve_profiled repeats it.
    Each window holds ``PROFILE_PAD_S`` of idle host time before and after
    its tick: the profiler drops a device record whose timestamp falls
    outside its window, and a guess (not confirmed) is that lost records
    are kernels near a window's edge whose device timestamps drifted
    against the host clock.  Each cycle costs a few hundred ms of host
    time; the wall time comes from the unprofiled run.  ``on_trace_ready``
    sees each cycle."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=0, active=1),
        acc_events=True, on_trace_ready=on_trace_ready)
    tick = eng.tick

    def profiled_tick():
        time.sleep(PROFILE_PAD_S)
        out = tick()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()
        return out

    eng.tick = profiled_tick
    return prof


def serve_profiled(params, cfg, kv_dtype, card: str, *, tries: int = 3,
                   run=None, **kw) -> dict:
    """``run`` (``serve_full`` by default) under the CUDA profiler, run
    again (up to ``tries`` runs) while the profiler records fewer
    attention-kernel instances than the engine launched.  The profiler drops a kernel record now and then
    (eager launches too, which the wrappers count exactly), so a short count
    alone does not show that a kernel failed to run; the check stays exact:
    one run must record every launch, and a count above the launches fails
    at once."""
    run = run or serve_full
    for attempt in range(1, tries + 1):
        try:
            return run(params, cfg, kv_dtype, card, profile="cuda", **kw)
        except RecordsLost as e:
            if attempt == tries:
                raise
            print(f"  {e}: profiling the run again ({attempt + 1} of {tries})")
        finally:
            gc.collect()


def serve_arms(params, cfg, kv_dtype, card: str, *, ragged: bool) -> dict:
    """The phase-4 workload through the captured and the eager engine, each
    unprofiled (wall time), under the CUDA profiler (busy time, idle share,
    kernel instances) and, with bf16 pools, under the CPU profiler (host
    ranges).  The captured transcripts must equal the eager ones token for
    token.  Returns {arm: unprofiled result} with "busy_ms" and "host_ms"
    filled in from the arm's profiled repeats."""
    t0 = time.perf_counter()
    res = {}
    for captured in (True, False):
        arm = "captured" if captured else "eager"
        kw = dict(ragged=ragged, captured=captured)
        res[arm] = serve_full(params, cfg, kv_dtype, card, **kw)
        gc.collect()
    assert res["captured"]["transcripts"] == res["eager"]["transcripts"], \
        "captured and eager transcripts differ"
    for captured in (True, False):
        arm = "captured" if captured else "eager"
        kw = dict(ragged=ragged, captured=captured)
        res[arm]["busy_ms"] = serve_profiled(params, cfg, kv_dtype, card,
                                             **kw)["busy_ms"]
        res[arm]["host_ms"] = {}
        if kv_dtype is None:  # the host ranges of both arms, bf16 pools
            res[arm]["host_ms"] = serve_full(params, cfg, kv_dtype, card,
                                             profile="cpu", **kw)["host_ms"]
            gc.collect()
    path = "ragged" if ragged else "two-phase"
    pools = kv_dtype or "bfloat16"
    for arm, r in res.items():
        wall_tick = r["wall_ms"] / r["ticks"]
        idle = ("not measured" if r["busy_ms"] is None else
                f"{1 - r['busy_ms'] / r['ticks'] / wall_tick:.3f}")
        busy = ("not measured" if r["busy_ms"] is None else
                f"{r['busy_ms'] / r['ticks']:.3f} ms")
        print(f"{path}, {pools} pools, {arm} on {card}: {wall_tick:.3f} ms per "
              f"tick, {r['tokens'] / r['wall_ms'] * 1e3:.1f} tokens/s, device "
              f"busy {busy} per tick (profiled repeat), idle share {idle}"
              + "".join(f", host {k.split('.')[1]} {v:.3f} ms"
                        for k, v in r["host_ms"].items()))
    print(f"{path}, {pools} pools: captured transcripts equal the eager ones "
          f"({res['captured']['tokens']} tokens); wall time per tick captured "
          f"/ eager = {res['captured']['wall_ms'] / res['captured']['ticks'] / (res['eager']['wall_ms'] / res['eager']['ticks']):.3f} "
          f"[{time.perf_counter() - t0:.1f} s]")
    return res


# ---------------------------------------------------------------------------
# 4b. full-width speculative serving (glm4-9b)

SPEC_K = 4
SPEC_TOKENS = 64  # output tokens per request


def spec_prompts(vocab: int, seed: int = 5) -> list:
    """tests/test_speculative.py's two prompt families at full vocabulary,
    64–512 tokens: four "tiled" prompts (a short random pattern repeated,
    which prompt lookup predicts) and four over the alphabet 1–4 (lookup
    always drafts, the model often disagrees: rejections and rollbacks)."""
    rng = np.random.RandomState(seed)
    tiled = [np.tile(rng.randint(0, vocab, p), -(-n // p))[:n]
             for p, n in ((6, 64), (8, 200), (12, 352), (16, 512))]
    return tiled + [rng.randint(1, 5, n) for n in (96, 240, 416, 480)]


def serve_spec(params, cfg, kv_dtype, card: str, *, spec_k: int,
               profile=None) -> dict:
    """The speculative workload (``spec_prompts``, 64 tokens each) through
    the captured ragged engine at ``spec_k`` (0: unspeculated), phase 4's
    settings.  Asserts every request's length, finite logits, the pools in
    place, the replay-aware kernel count (layers x ragged ticks, every
    replay; the wrappers count nothing), one trace, and, with ``spec_k``,
    the draft ledger: drafted = accepted + rejected, drafts accepted and
    rolled back.  ``profile="cuda"`` counts the "mma" attention-kernel
    instances against that count (``tally_profile``).  The host time of
    the logits copy is read around the ragged step's ``fetch``."""
    from repro_torch.kernels import ragged_paged_flash as rpf
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(params, cfg, batch_size=8, cache_len=2048, page_size=16,
                      prefill_chunk=128, token_budget=256, flash_decode=True,
                      kv_dtype=kv_dtype, spec_k=spec_k, device=params.device)
    ptrs = [t.data_ptr() for t in eng.pool_tensors()]  # builds the steps
    steps = [eng._ragged_step] + ([eng._rollback] if spec_k else [])
    st = eng.stats
    assert all(s.captured for s in steps), "capture state"
    assert st["graph_captures"] == len(steps), st
    sample, fetch, fetch_s = eng._sample, eng._ragged_step.fetch, [0.0]

    def checked_sample(req, row, ordinal):
        assert math.isfinite(row.min()) and math.isfinite(row.max()), \
            "non-finite logits"
        return sample(req, row, ordinal)

    def timed_fetch():
        t = time.perf_counter()
        rows = fetch()
        fetch_s[0] += time.perf_counter() - t
        return rows

    eng._sample, eng._ragged_step.fetch = checked_sample, timed_fetch
    prof = tick_profiler(eng) if profile == "cuda" else contextlib.nullcontext()
    prompts = spec_prompts(cfg.vocab_size)
    torch.cuda.synchronize()
    rpf.reset_launches()
    with prof:
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_tokens=SPEC_TOKENS) for p in prompts]
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = eng.stats
    assert all(len(results[h]) == SPEC_TOKENS for h in handles), \
        {int(h): len(results[h]) for h in handles}
    ticks, kticks, launches = st["ticks"], st["ragged_ticks"], st["kernel_launches"]
    assert launches == cfg.n_layers * kticks > 0 and rpf.launches == 0, (
        launches, kticks, rpf.launches)
    assert st["traces"] == 1, st
    assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs, "pools moved"
    assert eng.pool.pages_in_use == 0 and eng.reclaimable_pages == eng.n_pages
    if spec_k:
        assert st["spec_drafted"] == st["spec_accepted"] + st["spec_rejected"], st
        assert st["spec_drafted"] > 0 and st["spec_accepted"] > 0, st
        assert st["spec_rollbacks"] > 0, st
    toks = sum(len(results[h]) for h in handles)
    arm = f"spec_k {spec_k}"
    tag = ", profiled (cuda)" if profile else ""
    print(f"serve {cfg.name} full width ({cfg.n_layers} layers), ragged, captured, "
          f"pools {kv_dtype or 'bfloat16'}, {arm}{tag}, on {card}: "
          f"{len(handles)} requests, {toks} tokens in {wall:.3f} s = "
          f"{toks / wall:.1f} tokens/s, {ticks} ticks, {1e3 * wall / ticks:.2f} "
          f"ms/tick, {toks / st['sampled_slot_ticks']:.3f} tokens per sampled "
          f"slot-tick, logits copy {1e3 * fetch_s[0] / ticks:.3f} ms/tick "
          f"(host), drafted {st['spec_drafted']}, accepted "
          f"{st['spec_accepted']}, rejected {st['spec_rejected']}, rollbacks "
          f"{st['spec_rollbacks']}, kernel launches {launches} "
          f"({cfg.n_layers} x {kticks} ragged ticks), graphs captured "
          f"{st['graph_captures']}")
    out = dict(wall_ms=1e3 * wall, ticks=ticks, tokens=toks, busy_ms=None,
               launches=launches, sampled=st["sampled_slot_ticks"],
               fetch_ms=1e3 * fetch_s[0],
               transcripts=[list(results[h]) for h in handles],
               spec={k: st[k] for k in ("spec_drafted", "spec_accepted",
                                        "spec_rejected", "spec_rollbacks")})
    if profile == "cuda":
        out.update(tally_profile(prof, "ragged_paged_flash", cfg, launches,
                                 kticks, ticks, wall, arm))
    return out


def spec_phase(card: str) -> dict:
    """glm4-9b at full width cut to ``SPEC_LAYERS`` layers (untied head,
    seed-0 random weights, bf16 activations) serves the speculative
    workload captured at spec_k 0 and 4, with bf16 and with int8 pools:
    each pool type's two transcripts must be equal token for token.  The
    bf16 arms are repeated once each under the CUDA profiler (busy time,
    idle share, kernel instances)."""
    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as M

    cfg = cut_depth(get_config("glm4-9b"), SPEC_LAYERS)
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    print(f"glm4-9b full width, {cfg.n_layers} layers: "
          f"{param_count(cfg) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    res = {}
    for kv in (None, "int8"):
        for k in (0, SPEC_K):
            res[(kv, k)] = serve_spec(params, cfg, kv, card, spec_k=k)
            gc.collect()
        assert res[(kv, 0)]["transcripts"] == res[(kv, SPEC_K)]["transcripts"], \
            f"speculative transcripts differ (pools {kv or 'bfloat16'})"
    for k in (0, SPEC_K):
        res[(None, k)]["busy_ms"] = serve_profiled(
            params, cfg, None, card, run=serve_spec, spec_k=k).get("busy_ms")
    for (kv, k), r in res.items():
        wall_tick = r["wall_ms"] / r["ticks"]
        busy = ("not measured" if r["busy_ms"] is None else
                f"{r['busy_ms'] / r['ticks']:.3f} ms")
        idle = ("not measured" if r["busy_ms"] is None else
                f"{1 - r['busy_ms'] / r['ticks'] / wall_tick:.3f}")
        print(f"speculative serving, glm4-9b, pools {kv or 'bfloat16'}, spec_k "
              f"{k}, captured, on {card}: {r['ticks']} ticks, {wall_tick:.3f} ms "
              f"per tick, {r['tokens'] / r['wall_ms'] * 1e3:.1f} tokens/s, "
              f"{r['tokens'] / r['sampled']:.3f} tokens per sampled slot-tick, "
              f"device busy {busy} per tick (profiled repeat), idle share "
              f"{idle}, logits copy {r['fetch_ms'] / r['ticks']:.3f} ms per "
              f"tick (host), {r['spec']}")
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 4c. host tier, preemption and faults at full width (qwen2-1.5b)

# phase 4's engine settings; the tier's traffic: 16 prefix families of 1024
# tokens (64 pages), each request adding a 64-token suffix and asking for
# 32 tokens; a device pool that cannot hold two waves' prefixes
TIER_KW = dict(batch_size=8, cache_len=2048, page_size=16, prefill_chunk=128,
               token_budget=256, flash_decode=True)
TIER_PREFIX, TIER_SUFFIX, TIER_OUT = 1024, 64, 32
TIER_MAX_PAGES, TIER_HOST_PAGES = 600, 1024
# preemption: 8 batch requests (512 prompt, 256 output tokens) fill a pool
# sized to their footprint; 4 interactive ones (128, 32) arrive at tick 8
PRE_BATCH, PRE_CHAT, PRE_AT = (512, 256), (128, 32), 8
PRE_PAGES = 8 * -(-sum(PRE_BATCH) // 16)
PRE_HOST_PAGES = 128  # room for every park
FAULTS = dict(seed=11, p_alloc_fail=0.05, p_cancel=0.05, p_evict_storm=0.05,
              p_stall=0.05)


def tier_waves(vocab: int, seed: int = 6) -> dict:
    """Waves A (families 0-7), B (families 8-15, which pushes A's prefixes
    out of the device pool) and A' (A's prompts again)."""
    rng = np.random.RandomState(seed)
    fams = [rng.randint(0, vocab, TIER_PREFIX) for _ in range(16)]
    a = [np.concatenate([fams[i], rng.randint(0, vocab, TIER_SUFFIX)])
         for i in range(8)]
    b = [np.concatenate([fams[8 + i], rng.randint(0, vocab, TIER_SUFFIX)])
         for i in range(8)]
    return {"A": a, "B": b, "A'": a}


def host_store_leak_free(eng) -> bool:
    """Both tiers drained: no page referenced or parked, every device page
    reclaimable, host slots partitioned free/resident, and the engine's
    host bytes exactly the pool's host residency."""
    pool = eng.pool
    return (pool.pages_in_use == 0 and eng.reclaimable_pages == eng.n_pages
            and pool.parked_pages == 0
            and sorted(pool._host_free + list(pool._host_node))
            == list(range(pool.host_pages))
            and eng._host_slots == set(pool._host_node))


def no_sync_movers(eng):
    """Run the engine's page movers with CUDA's sync debug mode at "error":
    a mover that made the host wait for the card (a pageable copy, a
    ``.item()``) raises instead of passing."""
    apply = eng._apply_pool_events

    def checked(state):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return apply(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng._apply_pool_events = checked


def time_host(obj, name: str, acc: dict) -> None:
    """Wrap ``obj.name`` so that its host time adds up in ``acc[name]``
    (seconds, host clock; nothing waits for the card)."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t

    setattr(obj, name, timed)


class CopyTally:
    """Device time and bytes of the memory copies of a profiled run, from
    each profiler cycle's trace (its "Memcpy" events carry their bytes),
    summed per (direction, bytes)."""

    def __init__(self):
        self.by = {}

    def __call__(self, prof) -> None:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        for e in events:
            if not e.get("name", "").startswith("Memcpy"):
                continue
            kind = "D2H" if "DtoH" in e["name"] else "H2D" if "HtoD" in e["name"] \
                else "other"
            key = (kind, int(e.get("args", {}).get("bytes", -1)))
            n, us = self.by.get(key, (0, 0.0))
            self.by[key] = (n + 1, us + float(e.get("dur", 0.0)))

    def movers(self, sizes) -> dict:
        """{direction: (copies, bytes, device ms)} of the copies whose size
        is a mover's (one paged leaf of one page)."""
        out = {}
        for (kind, nbytes), (n, us) in self.by.items():
            if nbytes in sizes:
                c, b, ms = out.get(kind, (0, 0, 0.0))
                out[kind] = (c + n, b + n * nbytes, ms + us / 1e3)
        return out


def serve_tiered(params, cfg, kv_dtype, card: str, *, host_pages: int,
                 faults: bool = False, profile: bool = False) -> dict:
    """Waves A, B, A' through the captured ragged engine (phase 4's
    settings, ``TIER_MAX_PAGES`` device pages, ``host_pages`` host slots;
    with ``faults`` a seeded FaultInjector).  Asserts one trace, one graph,
    the pools in place, the movers free of host synchronisation, the host
    store pinned, and both tiers drained.  With ``profile`` wave A' runs
    under the CUDA profiler (one cycle per tick): busy time, the copies'
    device time (``CopyTally``), and the serving kernel's "mma" instances,
    which must equal the engine's launches in that wave.  Returns per-wave
    numbers and transcripts (None for a request a fault aborted)."""
    from repro_torch.kernels import ragged_paged_flash as rpf
    from repro_torch.serve.chaos import FaultInjector
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(params, cfg, kv_dtype=kv_dtype, max_pages=TIER_MAX_PAGES,
                      host_pages=host_pages, device=params.device,
                      fault_injector=FaultInjector(**FAULTS) if faults else None,
                      **TIER_KW)
    ptrs = [t.data_ptr() for t in eng.pool_tensors()]  # builds the steps
    on_card = params.device.type == "cuda"  # False when rehearsed on the CPU
    graphs = eng.stats["graph_captures"]
    assert graphs == int(on_card), eng.stats
    assert all(t.is_pinned() for t in eng._host_store.values())
    no_sync_movers(eng)
    host = {}  # host seconds in admission, its eviction scans, the movers
    time_host(eng, "_admit", host)
    time_host(eng.pool, "evict_one", host)
    time_host(eng, "_apply_pool_events", host)
    waves = tier_waves(cfg.vocab_size)
    out = {"waves": {}, "kernel_launches": 0}
    for name, ps in waves.items():
        before = eng.stats
        host.clear()
        prof, tally = None, None
        if profile and name == "A'":
            tally = CopyTally()
            prof = tick_profiler(eng, on_trace_ready=tally)
        torch.cuda.synchronize()
        rpf.reset_launches()
        t0 = time.perf_counter()
        with prof or contextlib.nullcontext():
            handles = [eng.submit(p, max_tokens=TIER_OUT) for p in ps]
            eng.run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            del eng.tick  # the profiler's wrapper
        st = eng.stats
        d = {k: st[k] - before[k] for k in (
            "ticks", "ragged_ticks", "packed_tokens", "host_hits",
            "host_pages_promoted", "demotions", "promotions", "evictions",
            "kernel_launches", "sampled_slot_ticks", "prefix_tokens_reused")}
        emitted = sum(len(h.request.out_tokens) for h in handles)
        w = dict(d, wall_ms=1e3 * wall, prefill_tokens=d["packed_tokens"] - emitted,
                 host_ms={k: 1e3 * v for k, v in host.items()},
                 transcripts=[None if h.request.error is not None
                              else list(h.request.out_tokens) for h in handles])
        assert d["kernel_launches"] == cfg.n_layers * d["ragged_ticks"] * on_card, d
        if not faults:
            assert all(len(t) == TIER_OUT for t in w["transcripts"]), name
        if prof is not None:
            w.update(tally_profile(prof, "ragged_paged_flash", cfg,
                                   d["kernel_launches"], d["ragged_ticks"],
                                   d["ticks"], wall, f"tiered wave A', {kv_dtype or 'bf16'}"))
            w["copies"] = tally.movers({rows.numel() * rows.element_size()
                                        for rows in eng._gather_page(
                                            eng._state, 0).values()})
        out["waves"][name] = w
        out["kernel_launches"] += d["kernel_launches"]
    st = eng.stats
    assert st["traces"] == 1 and st["graph_captures"] == graphs, st
    assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs, "pools moved"
    assert host_store_leak_free(eng), "pages leaked"
    out["stats"] = st
    return out


def serve_preempt(params, cfg, kv_dtype, card: str, *, host_pages: int,
                  preempt: bool = True, roomy: bool = False) -> dict:
    """Eight batch requests fill the pool; four interactive ones (priority
    1) arrive after ``PRE_AT`` ticks, through the captured engine under the
    slo scheduler.  ``roomy``: twelve slots and a pool for all twelve
    (nothing is preempted: the reference).  Returns the transcripts, the
    interactive requests' ticks to first token, and the stats."""
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.RandomState(7)
    batch = [rng.randint(0, cfg.vocab_size, PRE_BATCH[0]) for _ in range(8)]
    chats = [rng.randint(0, cfg.vocab_size, PRE_CHAT[0]) for _ in range(4)]
    kw = dict(TIER_KW, batch_size=12 if roomy else 8)
    eng = ServeEngine(params, cfg, kv_dtype=kv_dtype, scheduler="slo",
                      max_pages=2 * PRE_PAGES if roomy else PRE_PAGES,
                      host_pages=host_pages, preempt=preempt,
                      device=params.device, **kw)
    ptrs = [t.data_ptr() for t in eng.pool_tensors()]
    no_sync_movers(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hb = [eng.submit(p, max_tokens=PRE_BATCH[1]) for p in batch]
    for _ in range(PRE_AT):
        eng.tick()
    at = eng.stats["ticks"]
    hi = [eng.submit(p, max_tokens=PRE_CHAT[1], priority=1) for p in chats]
    first = {}
    while not eng.idle:
        eng.tick()
        for h in hi:
            if int(h) not in first and h.request.out_tokens:
                first[int(h)] = eng.stats["ticks"] - at
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    assert all(len(h.request.out_tokens) == PRE_BATCH[1] for h in hb)
    assert all(len(h.request.out_tokens) == PRE_CHAT[1] for h in hi)
    assert st["traces"] == 1, st
    assert st["graph_captures"] == int(params.device.type == "cuda"), st
    assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs, "pools moved"
    assert host_store_leak_free(eng), "pages leaked"
    return dict(wall_ms=1e3 * wall, stats=st,
                ttft=[first[int(h)] for h in hi],
                transcripts=[list(h.request.out_tokens) for h in hb + hi])


def contiguous_copy_ms(nbytes: int, kind: str) -> float:
    """The yardstick of the movers' copies: one contiguous copy of
    ``nbytes`` between pinned host memory and the card, by CUDA events
    (mean of 5 after a warm-up)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    src, dst = (dev, host) if kind == "D2H" else (host, dev)
    return cuda_ms(lambda: dst.copy_(src, non_blocking=True), iters=5,
                   warmup=1)


def tier_phase(card: str) -> dict:
    """Phase 4c: qwen2-1.5b FULL through the captured ragged engine with
    the host tier, preemption and injected faults; every check asserts."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = cut_depth(get_config("qwen2-1.5b"), SERVE_LAYERS)
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    res = {"launches": 0}
    for kv in (None, "int8"):
        pools = kv or "bfloat16"
        cold = serve_tiered(params, cfg, kv, card, host_pages=0)
        warm = serve_tiered(params, cfg, kv, card, host_pages=TIER_HOST_PAGES)
        gc.collect()
        for name in ("A", "B", "A'"):
            assert warm["waves"][name]["transcripts"] == \
                cold["waves"][name]["transcripts"], \
                f"tiered transcripts differ from untiered ({pools}, wave {name})"
        wa, ca = warm["waves"]["A'"], cold["waves"]["A'"]
        assert wa["host_hits"] > 0 and wa["host_pages_promoted"] > 0, wa
        assert warm["waves"]["B"]["demotions"] > 0, warm["waves"]["B"]
        print(f"tier, {pools} pools, on {card}: wave A' tiered {wa['wall_ms']:.3f} "
              f"ms ({wa['ticks']} ticks, {wa['prefill_tokens']} prefill tokens, "
              f"{wa['host_hits']} host hits, {wa['host_pages_promoted']} pages "
              f"promoted, {wa['demotions']} demoted) vs untiered "
              f"{ca['wall_ms']:.3f} ms ({ca['ticks']} ticks, "
              f"{ca['prefill_tokens']} prefill tokens); waves A, B: tiered "
              f"{warm['waves']['A']['wall_ms']:.3f}, "
              f"{warm['waves']['B']['wall_ms']:.3f} ms, untiered "
              f"{cold['waves']['A']['wall_ms']:.3f}, "
              f"{cold['waves']['B']['wall_ms']:.3f} ms; pool stats "
              f"{ {k: warm['stats'][k] for k in ('demotions', 'promotions', 'host_evictions', 'evictions')} }")
        for arm, w in (("tiered", wa), ("untiered", ca)):
            h = w["host_ms"]
            print(f"  wave A' {arm}, host ms (host clock): admission "
                  f"{h.get('_admit', 0.0):.3f}, of which the pool's eviction "
                  f"scans {h.get('evict_one', 0.0):.3f} ({w['demotions'] + w['evictions']} "
                  f"evictions) and the page movers {h.get('_apply_pool_events', 0.0):.3f}")
        chaos = serve_tiered(params, cfg, kv, card, host_pages=TIER_HOST_PAGES,
                             faults=True)
        done = 0
        for name, w in chaos["waves"].items():
            for got, want in zip(w["transcripts"],
                                 warm["waves"][name]["transcripts"]):
                if got is not None and len(got) == TIER_OUT:
                    assert got == want, f"chaos transcript differs ({pools}, {name})"
                    done += 1
        cst = chaos["stats"]
        faults = {k: cst[k] for k in ("chaos_alloc_fails", "chaos_cancels",
                                      "chaos_evict_storms", "chaos_stalled_ticks")}
        assert done > 0 and sum(faults.values()) > 0, (done, faults)
        print(f"tier with faults, {pools} pools: {done} of 24 requests completed, "
              f"equal to the fault-free transcripts; {faults}")
        res["launches"] += (cold["kernel_launches"] + warm["kernel_launches"]
                            + chaos["kernel_launches"])
        res[(kv, "A'")] = (wa, ca)
        gc.collect()
    # one profiled repeat of the bf16 tiered waves (wave A' profiled)
    for attempt in range(1, 4):
        try:
            prof = serve_tiered(params, cfg, None, card,
                                host_pages=TIER_HOST_PAGES, profile=True)
            break
        except RecordsLost as e:
            if attempt == 3:
                raise
            print(f"  {e}: profiling the run again ({attempt + 1} of 3)")
        finally:
            gc.collect()
    pw = prof["waves"]["A'"]
    res["launches"] += prof["kernel_launches"]
    wall = res[(None, "A'")][0]["wall_ms"]
    if pw.get("busy_ms") is not None:
        print(f"wave A' tiered, bf16, profiled repeat, on {card}: device busy "
              f"{pw['busy_ms']:.3f} ms in {pw['ticks']} ticks = "
              f"{pw['busy_ms'] / pw['ticks']:.3f} ms per tick; idle share "
              f"against the unprofiled wave ({wall:.3f} ms): "
              f"{1 - pw['busy_ms'] / wall:.3f}; kernel launches "
              f"{pw['kernel_launches']} = profiled ragged_mma_kernel instances")
    copies = pw.get("copies") or {}
    if not copies:
        print("  mover copies: not measured (no gpu_memcpy of a mover's size "
              "in the trace)")
    for kind, (n, nbytes, ms) in sorted(copies.items()):
        ref = contiguous_copy_ms(nbytes, kind)
        print(f"  mover copies {kind}, wave A' (profiler, device time): {n} "
              f"copies, {nbytes} bytes in {ms:.3f} ms = {nbytes / ms / 1e6:.2f} "
              f"GB/s; one contiguous pinned copy of the same bytes (CUDA "
              f"events): {ref:.3f} ms = {nbytes / ref / 1e6:.2f} GB/s")
    # preemption, both resume paths, beside a run with room for everyone
    for kv in (None, "int8"):
        pools = kv or "bfloat16"
        ref = serve_preempt(params, cfg, kv, card, host_pages=0, roomy=True)
        assert ref["stats"]["preemptions"] == 0, ref["stats"]
        runs = {"park": serve_preempt(params, cfg, kv, card,
                                      host_pages=PRE_HOST_PAGES),
                "re-prefill": serve_preempt(params, cfg, kv, card, host_pages=0)}
        if kv is None:
            runs["no preemption"] = serve_preempt(params, cfg, kv, card,
                                                  host_pages=0, preempt=False)
        for arm, r in runs.items():
            st = r["stats"]
            assert r["transcripts"] == ref["transcripts"], \
                f"preempted transcripts differ ({pools}, {arm})"
            if arm == "park":
                assert st["preemptions"] > 0 and st["resume_park_hits"] > 0, st
            elif arm == "re-prefill":
                assert st["preemptions"] > 0 and st["resume_reprefills"] > 0, st
            print(f"preemption, {pools} pools, {arm}, on {card}: "
                  f"{st['preemptions']} preemptions, {st['resume_park_hits']} "
                  f"park hits, {st['resume_reprefills']} re-prefills, "
                  f"{st['preempt_pages_parked']} pages parked; interactive "
                  f"ticks to first token {r['ttft']} (roomy reference "
                  f"{ref['ttft']}); {st['ticks']} ticks, {r['wall_ms']:.3f} ms")
        gc.collect()
    assert res["launches"] > 0
    del params
    torch.cuda.empty_cache()
    print(f"phase 4c: {res['launches']} ragged_paged_flash launches (replay-"
          f"aware counts of the tier runs) [{time.perf_counter() - t0:.1f} s]")
    return res


# ---------------------------------------------------------------------------
# 4d. sliding-window serving at full width (gemma3-4b) and the lock-step path

# phase 4's engine settings; 8 requests of 200-1900 prompt tokens, five
# longer than the 1024-token window, 32 output tokens each
GEMMA_KW = dict(batch_size=8, cache_len=2048, page_size=16, prefill_chunk=128,
                token_budget=256, flash_decode=True)
GEMMA_LENS = (200, 1900, 1100, 450, 1500, 1300, 700, 1050)
GEMMA_OUT = 32
GEMMA_TWO_PHASE_REPEATS = 2  # the two-phase path's cut: 12 layers, 2 global
# the lock-step engine's wave: equal lengths (all it serves), past the window
LOCKSTEP_WAVE, LOCKSTEP_LEN = 4, 1200


def global_layers(cfg) -> int:
    """Attention layers of ``cfg`` without a window: the paged ones, each
    launching the serving kernel once a kernel tick."""
    return sum(st.repeats for st in cfg.stages for blk in st.pattern
               if blk.mixer == "attn" and blk.attn.window is None)


def serve_wave(params, cfg, kv_dtype, card: str, *, ragged: bool = True,
               captured: bool = True, profile=None, kw=GEMMA_KW,
               lens=GEMMA_LENS, out_tokens=GEMMA_OUT, seed=7,
               variant="simt") -> dict:
    """A wave of requests (``lens`` prompt tokens, ``out_tokens`` each,
    from ``seed``; the gemma3 workload by default) once through the ragged
    engine or, with ``ragged=False``, the two-phase engine, at engine
    settings ``kw``, captured or eager.  Asserts every request's length,
    finite logits, the gates of a model with a per-slot layer (windowed or
    recurrent: no prefix cache, no speculation, no preemption), the pools
    in place, and the kernel launches: one per global layer a kernel tick
    (replay-aware when captured; eager, the wrappers' own count, all
    ``variant``).  Each admission's slot reset is bracketed by CUDA events
    (outside any graph).  ``profile="cuda"`` counts the ``variant``
    attention-kernel instances against the launches (``tally_profile``)."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import ragged_paged_flash as rpf
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    kmod, kname, fn = ((rpf, "ragged_paged_flash", f"ragged_{variant}_kernel")
                       if ragged else
                       (pfd, "paged_flash_decode", f"decode_{variant}_kernel"))
    eng = ServeEngine(params, cfg, kv_dtype=kv_dtype, ragged=ragged,
                      device=params.device, cuda_graph=captured, **kw)
    assert not eng.prefix_cache and eng._spec_k == 0 and not eng.preempt
    ptrs = [t.data_ptr() for t in eng.pool_tensors()]  # builds the steps
    steps = ([eng._ragged_step] if ragged
             else [eng._chunk_step, eng._decode_step])
    assert eng.stats["graph_captures"] == (len(steps) if captured else 0)
    sample = eng._sample

    def checked_sample(req, row, ordinal):
        assert math.isfinite(row.min()) and math.isfinite(row.max()), \
            "non-finite logits"
        return sample(req, row, ordinal)

    eng._sample = checked_sample
    resets = []
    reset = M.reset_paged_slots

    def timed_reset(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = reset(*a, **kw)
        end.record()
        resets.append((start, end))
        return out

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    prof = tick_profiler(eng) if profile == "cuda" else contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kmod.reset_launches()
    M.reset_paged_slots = timed_reset
    try:
        with prof:
            t0 = time.perf_counter()
            handles = [eng.submit(p, max_tokens=out_tokens) for p in prompts]
            results = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        M.reset_paged_slots = reset
    st = eng.stats
    assert all(len(results[h]) == out_tokens for h in handles), \
        {int(h): len(results[h]) for h in handles}
    layers = global_layers(cfg)
    kticks = st["ragged_ticks"] if ragged else st["decode_ticks"]
    launches = st["kernel_launches"]
    assert launches == layers * kticks > 0, (launches, layers, kticks)
    if captured:
        assert kmod.launches == 0, kmod.launches
    else:
        assert kmod.launches == launches == kmod.launches_by_variant[variant], \
            (kmod.launches, launches, kmod.launches_by_variant)
    assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs, "pools moved"
    assert eng.pool.pages_in_use == 0 and eng.reclaimable_pages == eng.n_pages
    toks = sum(len(results[h]) for h in handles)
    ticks = st["ticks"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_ms = sum(a.elapsed_time(b) for a, b in resets)
    arm = "captured" if captured else "eager"
    tag = f", profiled ({profile})" if profile else ""
    kind = ("ragged" if ragged else
            f"two-phase ({st['chunk_ticks']} prefill, {st['decode_ticks']} decode ticks)")
    print(f"serve {cfg.name} FULL width ({cfg.n_layers} layers, {layers} "
          f"global), {kind}, pools {kv_dtype or 'bfloat16'}, {arm}{tag}, on "
          f"{card}: {len(handles)} requests, {toks} tokens in {wall:.3f} s = "
          f"{toks / wall:.1f} tokens/s, {ticks} ticks, "
          f"{1e3 * wall / ticks:.3f} ms/tick, peak memory {peak:.2f} GiB, "
          f"kernel launches {launches} ({layers} x {kticks} kernel ticks), "
          f"slot resets {len(resets)} in {reset_ms:.3f} ms (CUDA events), "
          f"n_pages {eng.n_pages}")
    out = dict(wall_ms=1e3 * wall, ticks=ticks, tokens=toks, busy_ms=None,
               launches=launches, kernel_ticks=kticks, peak_gib=peak,
               reset_ms=reset_ms, resets=len(resets),
               transcripts=[list(results[h]) for h in handles])
    if profile == "cuda":
        out.update(tally_profile(prof, kname, cfg, launches, kticks, ticks,
                                 wall, arm, instances=fn, per_tick=layers))
    return out


def lockstep_run(params, cfg, card: str, prompts, max_tokens: int, *,
                 first_logits: bool = False) -> dict:
    """One wave through the lock-step ``ReferenceEngine`` (batch = the
    wave, cache_len 2048), each decode tick bracketed by CUDA events;
    ``first_logits`` keeps the first tick's float32 logits (B, V) on the
    host (that tick waits for the card)."""
    from repro_torch.serve.reference import ReferenceEngine

    eng = ReferenceEngine(params, cfg, batch_size=len(prompts),
                          cache_len=GEMMA_KW["cache_len"], device=params.device)
    spans, first = [], []
    decode = eng._decode

    def timed(p, s, t):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        logits, s = decode(p, s, t)
        end.record()
        spans.append((start, end))
        if first_logits and not first:
            first.append(logits[:, -1].float().cpu())
        return logits, s

    eng._decode = timed
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(len(results[u]) == max_tokens for u in uids)
    tick_ms = sum(a.elapsed_time(b) for a, b in spans) / len(spans)
    print(f"ReferenceEngine (lock-step) {cfg.name} ({cfg.n_layers} layers, "
          f"{cfg.dtype}) on {card}: {len(prompts)} x {len(prompts[0])} prompt "
          f"tokens, {max_tokens} out, {len(spans)} decode ticks at "
          f"{tick_ms:.3f} ms each (CUDA events around the eager step), "
          f"{wall:.3f} s in all (batch-1 prefills included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(transcripts=[list(results[u]) for u in uids], tick_ms=tick_ms,
                wall_ms=1e3 * wall, first=first[0] if first else None)


def gemma_phase(card: str) -> dict:
    """Phase 4d: gemma3-4b FULL (34 layers: 29 windowed, 5 global; seed-0
    random weights, bf16 activations) through the ragged engine, captured
    and eager, with bf16 and int8 pools (captured transcripts must equal
    eager ones), the captured bf16 run repeated under the CUDA profiler
    (busy time, idle share, "simt" instances = 5 x ticks); the lock-step
    ReferenceEngine at full depth on an equal-length wave; then the
    two-phase engine at the first 12 layers (10 windowed, 2 global), bf16
    and int8 pools, kernel 2 launched twice a decode tick."""
    from repro_torch.configs import Stage, get_config, param_count
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = get_config("gemma3-4b")
    assert global_layers(cfg) == 5 and cfg.n_layers == 34
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    print(f"gemma3-4b FULL: {param_count(cfg) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    res = {}
    for kv in (None, "int8"):
        cap = serve_wave(params, cfg, kv, card)
        eager = serve_wave(params, cfg, kv, card, captured=False)
        gc.collect()
        assert cap["transcripts"] == eager["transcripts"], \
            f"captured and eager transcripts differ ({kv or 'bfloat16'})"
        res[kv] = {"captured": cap, "eager": eager}
    prof = serve_profiled(params, cfg, None, card, run=serve_wave)
    res[None]["captured"]["busy_ms"] = prof.get("busy_ms")
    for kv, arms in res.items():
        for arm, r in arms.items():
            wall_tick = r["wall_ms"] / r["ticks"]
            busy = ("not measured" if r["busy_ms"] is None else
                    f"{r['busy_ms'] / r['ticks']:.3f} ms")
            idle = ("not measured" if r["busy_ms"] is None else
                    f"{1 - r['busy_ms'] / r['ticks'] / wall_tick:.3f}")
            print(f"gemma3-4b ragged, {kv or 'bfloat16'} pools, {arm} on {card}: "
                  f"{wall_tick:.3f} ms per tick, "
                  f"{r['tokens'] / r['wall_ms'] * 1e3:.1f} tokens/s, device busy "
                  f"{busy} per tick (profiled repeat), idle share {idle}, peak "
                  f"memory {r['peak_gib']:.2f} GiB, {r['resets']} slot resets "
                  f"{r['reset_ms']:.3f} ms")
    rng = np.random.RandomState(8)
    wave = [rng.randint(0, cfg.vocab_size, LOCKSTEP_LEN)
            for _ in range(LOCKSTEP_WAVE)]
    ref = lockstep_run(params, cfg, card, wave, GEMMA_OUT)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = cfg.replace(stages=(Stage(cfg.stages[0].pattern,
                                    GEMMA_TWO_PHASE_REPEATS),))
    assert cut.n_layers == 12 and global_layers(cut) == 2
    p12 = M.init_params(cut, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    two = {kv: serve_wave(p12, cut, kv, card, ragged=False)
           for kv in (None, "int8")}
    for r in two.values():
        assert r["launches"] == 2 * r["kernel_ticks"], r["launches"]
    del p12
    torch.cuda.empty_cache()
    print(f"phase 4d: ragged_paged_flash {res[None]['captured']['launches']} "
          f"launches (5 x {res[None]['captured']['kernel_ticks']} ticks), "
          f"paged_flash_decode {two[None]['launches']} (2 x "
          f"{two[None]['kernel_ticks']} decode ticks), lock-step "
          f"{ref['tick_ms']:.3f} ms a tick [{time.perf_counter() - t0:.1f} s]")
    return {"ragged": res, "two_phase": two, "lockstep": ref}


def lockstep_vs_ragged(card: str) -> None:
    """Phase 5's lock-step check: gemma3-4b at full width in float32, cut
    to 12 layers (10 windowed, 2 global), an equal-length wave of 4 x 1100
    prompt tokens (past the 1024 window), 16 tokens each, through the
    lock-step ReferenceEngine and the captured ragged engine on the kernel
    and the gather routes: greedy transcripts equal, and each request's
    first-step logits within rtol 1e-3, atol 1e-3 x max |logit| of the
    lock-step engine's."""
    from repro_torch.configs import Stage, get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    gem = get_config("gemma3-4b")
    g32 = gem.replace(dtype="float32", stages=(Stage(gem.stages[0].pattern, 2),))
    p32 = M.init_params(g32, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    rng = np.random.RandomState(9)
    wave = [rng.randint(0, g32.vocab_size, 1100) for _ in range(4)]
    ref = lockstep_run(p32, g32, card, wave, 16, first_logits=True)
    scale = float(ref["first"].abs().max())
    for flash in (True, False):
        eng = ServeEngine(p32, g32, device="cuda",
                          **{**GEMMA_KW, "flash_decode": flash})
        first = {}
        sample = eng._sample

        def recording(req, row, ordinal, sample=sample, first=first):
            if ordinal == 0:
                first[req.uid] = torch.from_numpy(row.copy())
            return sample(req, row, ordinal)

        eng._sample = recording
        uids = [eng.submit(p, max_tokens=16) for p in wave]
        results = eng.run()
        route = "kernel" if flash else "gather"
        assert [results[u] for u in uids] == ref["transcripts"], \
            f"lock-step and ragged ({route}) transcripts differ"
        got = torch.stack([first[u] for u in uids])
        torch.testing.assert_close(got, ref["first"], rtol=1e-3,
                                   atol=1e-3 * scale)
        print(f"lock-step vs ragged engine ({route} route), gemma3-4b widths "
              f"f32 (12 layers), 4 x 1100 prompt tokens on {card}: transcripts "
              f"equal ({sum(len(results[u]) for u in uids)} tokens), "
              f"first-step logits max |diff| "
              f"{float((got - ref['first']).abs().max()):.3e} (max |logit| "
              f"{scale:.2f}), kernel launches {eng.stats['kernel_launches']}")
        del eng
        gc.collect()
    del p32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4e. recurrent serving at full width (xlstm-350m)

# 8 requests of 64-512 prompt tokens, 32 output tokens each; phase 4's
# batch and token budget.  The prefill chunk sets the roll's width: every
# tick rolls the single-step decode chunk + 1 times a layer, whatever the
# pack holds (JAX's design).  At phase 4's chunk of 128 the phase took
# 340 s on an NVIDIA H100 80GB HBM3 at 700 W (41 ticks of 780 ms captured
# and 4.25 s eager, 169,575 kernels a replay; PERF.md), over a quarter of
# the script's time limit, so it runs at 32 (width 33), an engine setting
# JAX has too.
XLSTM_LENS = (64, 512, 200, 384, 96, 448, 256, 320)
XLSTM_OUT = 32
XLSTM_CHUNK = 32
XLSTM_KW = dict(batch_size=8, cache_len=1024, page_size=16,
                prefill_chunk=XLSTM_CHUNK, token_budget=256, flash_decode=True)


def serve_xlstm(params, cfg, card: str, *, captured: bool = True,
                profile=()) -> dict:
    """The xlstm workload (``XLSTM_LENS``, ``XLSTM_OUT`` tokens each, seed
    10) once through the ragged engine, captured or eager, each tick timed
    on the host (it ends waiting for its logits).  Asserts every request's
    length, finite logits, the recurrent gates (no paged layer: no prefix
    cache, speculation or preemption, one block table a slot of pages, no
    pool tensor), no attention-kernel launch (there is nothing to launch),
    and every state leaf in place.  The ticks whose indices ``profile``
    lists run under their own CUDA profiler session: their device busy
    time and kernel count."""
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels import ragged_paged_flash as rpf
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(params, cfg, device=params.device, cuda_graph=captured,
                      **XLSTM_KW)
    assert not eng._has_paged and not eng.prefix_cache
    assert eng._spec_k == 0 and not eng.preempt and eng.host_pages == 0
    assert eng.n_pages == eng.B * eng.pps
    t0 = time.perf_counter()
    assert eng.pool_tensors() == []  # builds (and captures) the step
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    leaves = [t for ss in eng._state["layers"] for c in ss for t in c.values()]
    ptrs = [t.data_ptr() for t in leaves]
    state_gib = sum(t.numel() * t.element_size() for t in leaves) / 2**30
    assert eng.stats["graph_captures"] == (1 if captured else 0)
    sample = eng._sample

    def checked_sample(req, row, ordinal):
        assert math.isfinite(row.min()) and math.isfinite(row.max()), \
            "non-finite logits"
        return sample(req, row, ordinal)

    eng._sample = checked_sample
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in XLSTM_LENS]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rpf.reset_launches()
    pfd.reset_launches()
    handles = [eng.submit(p, max_tokens=XLSTM_OUT) for p in prompts]
    results, walls, prof = {}, [], {}
    t0 = time.perf_counter()
    while not eng.idle:
        i = len(walls)
        session = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
            if i in profile else contextlib.nullcontext())
        with session:
            start = time.perf_counter()
            results.update(eng.tick())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        if i in profile:
            events = [e for e in session.key_averages() if _device_us(e) > 0]
            prof[i] = dict(busy_ms=sum(_device_us(e) for e in events) / 1e3,
                           kernels=sum(e.count for e in events))
    wall = time.perf_counter() - t0
    st = eng.stats
    assert all(len(results[h]) == XLSTM_OUT for h in handles), \
        {int(h): len(results[h]) for h in handles}
    assert st["kernel_launches"] == rpf.launches == pfd.launches == 0, \
        (st["kernel_launches"], rpf.launches, pfd.launches)
    assert [t.data_ptr() for t in leaves] == ptrs, "state moved"
    toks = sum(len(results[h]) for h in handles)
    ticks = st["ticks"]
    assert ticks == len(walls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    arm = "captured" if captured else "eager"
    print(f"serve xlstm-350m FULL ({cfg.n_layers} layers), ragged, "
          f"prefill_chunk {eng.chunk} (roll width {eng.width}), {arm}, on "
          f"{card}: {len(handles)} requests, {toks} tokens in {wall:.3f} s = "
          f"{toks / wall:.2f} tokens/s, {ticks} ticks, "
          f"{1e3 * wall / ticks:.1f} ms/tick (median "
          f"{1e3 * float(np.median(walls)):.1f}), build"
          f"{' and capture' if captured else ''} {build_s:.1f} s, state "
          f"{state_gib:.3f} GiB, "
          f"peak memory {peak:.2f} GiB; attention-kernel launches 0: no "
          f"paged layer, nothing to launch")
    return dict(wall_ms=1e3 * wall, ticks=ticks, tokens=toks, walls=walls,
                peak_gib=peak, build_s=build_s, profiled=prof,
                transcripts=[list(results[h]) for h in handles])


def xlstm_phase(card: str) -> dict:
    """Phase 4e: xlstm-350m FULL (24 layers: 21 mLSTM, 3 sLSTM; seed-0
    weights, bf16 activations) through the ragged engine captured and
    eager: equal transcripts; then a captured repeat with four ticks
    profiled (the first two, prefill, and two decode ticks near the end):
    device busy time, idle share against the unprofiled captured run's
    same ticks, and the kernels a replay runs."""
    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = get_config("xlstm-350m")
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    print(f"xlstm-350m FULL: {param_count(cfg) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cap = serve_xlstm(params, cfg, card)
    gc.collect()
    eager = serve_xlstm(params, cfg, card, captured=False)
    gc.collect()
    assert cap["transcripts"] == eager["transcripts"], \
        "captured and eager transcripts differ"
    n = cap["ticks"]
    picks = (0, 1, n - 3, n - 2)
    prof = serve_xlstm(params, cfg, card, profile=picks)
    gc.collect()
    assert prof["transcripts"] == cap["transcripts"]
    for i, r in sorted(prof["profiled"].items()):
        wall = 1e3 * cap["walls"][i]
        print(f"  tick {i} (captured, profiled) on {card}: device busy "
              f"{r['busy_ms']:.2f} ms in {r['kernels']} kernels and copies "
              f"(the graph's kernels a replay); "
              f"the unprofiled tick {wall:.2f} ms, idle share "
              f"{1 - r['busy_ms'] / wall:.3f}")
    for name, r in (("captured", cap), ("eager", eager)):
        print(f"xlstm-350m ragged, {name} on {card}: "
              f"{r['wall_ms'] / r['ticks']:.1f} ms per tick, "
              f"{r['tokens'] / r['wall_ms'] * 1e3:.2f} tokens/s, peak memory "
              f"{r['peak_gib']:.2f} GiB")
    print(f"phase 4e: captured transcripts equal the eager ones "
          f"({cap['tokens']} tokens); captured / eager wall per tick "
          f"{cap['wall_ms'] / eager['wall_ms']:.3f} "
          f"[{time.perf_counter() - t0:.1f} s]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"captured": cap, "eager": eager, "profiled": prof["profiled"]}


# ---------------------------------------------------------------------------
# 4f/4g. MoE and hybrid serving at full width (llama4-maverick, jamba)

# jamba's serving wave: phase 4e's settings (the roll's width is the prefill
# chunk + 1, 33) and requests
JAMBA_KW = dict(XLSTM_KW, cache_len=1024)


def cut_stage(cfg, layers: int):
    """``cfg``'s one stage cut to the first ``layers`` positions of its
    pattern, once (full width)."""
    from repro_torch.configs import Stage

    return cfg.replace(stages=(Stage(cfg.stages[0].pattern[:layers], 1),))


def moe_layer_ms(params, cfg, card: str, T: int) -> list:
    """Each MoE layer of ``params`` timed alone on a (1, T, d) bf16 pack
    (the ragged step's layout, capacity over the T tokens): device time
    (``device_ms``) beside the byte floor of its expert weights (every
    expert is read: the dispatch runs each expert over its C slots) and
    its capacity.  Returns [(ms, floor ms)] a layer."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import moe

    dev = params.device
    x = torch.randn(1, T, cfg.d_model, device=dev,
                    generator=torch.Generator(dev).manual_seed(3)
                    ).to(getattr(torch, cfg.dtype))
    out = []
    for blk, bp in zip(cfg.stages[0].pattern, params.stages[0]):
        if blk.ffn != "moe":
            continue
        p = tfm.layer_view(bp, 0)["ffn"]
        nbytes = sum(p[k].numel() * p[k].element_size()
                     for k in ("we_gate", "we_up", "we_down"))
        with torch.no_grad():
            ms = device_ms(lambda: moe.moe_fwd(p, blk.moe, x), iters=10)
        floor = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  MoE layer ({blk.moe.num_experts} experts top-{blk.moe.top_k}, "
              f"d_ff {blk.moe.d_ff}, capacity {moe.capacity(blk.moe, T)} "
              f"of {T} tokens) alone at T={T} on {card}: device "
              f"{fmt_ms(ms)}; its experts' {nbytes / 1e9:.2f} GB over "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {floor:.2f} ms floor")
        out.append((ms, floor))
    return out


def busy_line(name: str, card: str, r: dict) -> str:
    wall_tick = r["wall_ms"] / r["ticks"]
    busy = r.get("busy_ms")
    return (f"{name} on {card}: {wall_tick:.3f} ms per tick, "
            f"{r['tokens'] / r['wall_ms'] * 1e3:.2f} tokens/s"
            + ("" if busy is None else
               f", device busy {busy / r['ticks']:.3f} ms per tick (profiled "
               f"repeat), idle share {1 - busy / r['ticks'] / wall_tick:.3f}"))


def llama4_phase(card: str) -> dict:
    """Phase 4f: llama4-maverick-400b-a17b at full width, its first period
    (2 layers: dense, then MoE with 128 experts top-1 and the shared
    expert; untied vocab 202048; seed-0 weights, bf16 activations) through
    phase 4's ragged workload (``serve_full``: prefix hits and
    copy-on-write, 2 launches of kernel 1 a tick, all "mma"), captured and
    eager (equal transcripts), the captured arm profiled (busy time, idle
    share, kernel-1 instances = launches); the MoE layer alone at the
    pack's shape beside its expert-read floor."""
    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = cut_stage(get_config("llama4-maverick-400b-a17b"), 2)
    assert [b.ffn for b in cfg.stages[0].pattern] == ["mlp", "moe"]
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() / 2**30
    print(f"llama4-maverick-400b-a17b, first period at full width (2 layers): "
          f"{param_count(cfg) / 1e9:.3f} B parameters, {weights:.2f} GiB "
          f"allocated, init peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, built in {time.perf_counter() - t0:.1f} s")
    cap = serve_full(params, cfg, None, card)
    gc.collect()
    eager = serve_full(params, cfg, None, card, captured=False)
    gc.collect()
    assert cap["transcripts"] == eager["transcripts"], \
        "captured and eager transcripts differ"
    assert cap["launches"] == 2 * cap["kernel_ticks"] > 0, cap["launches"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = serve_profiled(params, cfg, None, card)
    cap["busy_ms"] = prof.get("busy_ms")
    moe = moe_layer_ms(params, cfg, card, T=256)
    for name, r in (("captured", cap), ("eager", eager)):
        print(busy_line(f"llama4 (2 layers) ragged, bf16 pools, {name}", card, r))
    if cap["busy_ms"] is not None and moe[0][0] is not None:
        busy_tick = cap["busy_ms"] / cap["ticks"]
        print(f"  MoE layer share of the captured tick's busy time: "
              f"{moe[0][0] / busy_tick:.3f} ({fmt_ms(moe[0][0])} alone against "
              f"{busy_tick:.3f} ms busy a tick); expert-read floor "
              f"{moe[0][1]:.2f} ms a tick")
    print(f"phase 4f: captured transcripts equal the eager ones "
          f"({cap['tokens']} tokens), ragged_paged_flash {cap['launches']} "
          f"launches (2 x {cap['kernel_ticks']} ticks), peak memory "
          f"{peak:.2f} GiB (weights {weights:.2f} GiB) "
          f"[{time.perf_counter() - t0:.1f} s]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"captured": cap, "eager": eager, "moe": moe}


def jamba_phase(card: str) -> dict:
    """Phase 4g: jamba-1.5-large-398b at full width, the first five layers
    of its period (mamba+MLP, mamba+MoE, mamba+MLP, mamba+MoE,
    attention+MLP: every block kind; d 8192, d_in 16384, d_state 16, 16
    experts top-2 of d_ff 24576, 64 over 8 KV heads; seed-0 weights, bf16
    activations) through the ragged engine at phase 4e's settings
    (``JAMBA_KW``, the xlstm wave), captured and eager (equal transcripts;
    the recurrent gates; kernel 1 once a tick, all "mma"), the captured arm
    profiled (busy time, idle share, kernel-1 instances = launches, kernels
    a replay); the MoE layers alone beside their expert-read floor and the
    roll's Mamba weight reads."""
    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = cut_stage(get_config("jamba-1.5-large-398b"), 5)
    kinds = [(b.mixer, b.ffn) for b in cfg.stages[0].pattern]
    assert kinds == [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
                     ("mamba", "moe"), ("attn", "mlp")], kinds
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() / 2**30
    print(f"jamba-1.5-large-398b, first 5 layers of its period at full width: "
          f"{param_count(cfg) / 1e9:.3f} B parameters, {weights:.2f} GiB "
          f"allocated, init peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, built in {time.perf_counter() - t0:.1f} s")
    wave = dict(kw=JAMBA_KW, lens=XLSTM_LENS, out_tokens=XLSTM_OUT, seed=10,
                variant="mma")
    cap = serve_wave(params, cfg, None, card, **wave)
    eager = serve_wave(params, cfg, None, card, captured=False, **wave)
    gc.collect()
    assert cap["transcripts"] == eager["transcripts"], \
        "captured and eager transcripts differ"
    assert cap["launches"] == cap["kernel_ticks"] > 0, cap["launches"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = serve_profiled(params, cfg, None, card, run=serve_wave, **wave)
    cap["busy_ms"] = prof.get("busy_ms")
    moe = moe_layer_ms(params, cfg, card, T=JAMBA_KW["token_budget"])
    mamba_bytes = [sum(t.numel() * t.element_size() for t in bp.mixer.parameters())
                   for blk, bp in zip(cfg.stages[0].pattern, params.stages[0])
                   if blk.mixer == "mamba"]
    width = JAMBA_KW["prefill_chunk"] + 1
    roll_ms = width * sum(mamba_bytes) / HBM_BYTES_PER_S * 1e3
    for name, r in (("captured", cap), ("eager", eager)):
        print(busy_line(f"jamba (5 layers) ragged, bf16 pools, {name}", card, r))
    if prof.get("kernels"):
        print(f"  kernels a replay (profiled captured run): "
              f"{prof['kernels'] / cap['ticks']:.0f} a tick")
    print(f"  the roll reads each Mamba layer's "
          f"{mamba_bytes[0] / 1e9:.3f} GB of weights {width} times a tick: "
          f"{len(mamba_bytes)} layers, {roll_ms:.1f} ms a tick at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; the MoE layers' expert reads "
          f"{sum(f for _, f in moe):.1f} ms; floor "
          f"{roll_ms + sum(f for _, f in moe):.1f} ms a tick")
    print(f"phase 4g: captured transcripts equal the eager ones "
          f"({cap['tokens']} tokens), ragged_paged_flash {cap['launches']} "
          f"launches (1 x {cap['kernel_ticks']} ticks), peak memory "
          f"{peak:.2f} GiB (weights {weights:.2f} GiB) "
          f"[{time.perf_counter() - t0:.1f} s]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"captured": cap, "eager": eager, "moe": moe, "roll_ms": roll_ms}


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


def verify_route_logits(params, cfg, flashes, *, fills, drafts, T, cache_len,
                        page, seed):
    """Prefill slot b to ``fills[b]`` tokens from a fresh state (gather
    route, one slot's chunk of at most T tokens a step), then ONE verify
    step — every slot's decode token, then each slot's ``drafts`` draft
    tokens as a later run, ``logit_idx`` (B, 1 + drafts) — from that state
    once per entry of ``flashes`` (each on its own copy).  Returns each
    run's (B, 1 + drafts, V) logits, in order."""
    from repro_torch.models import model as M

    dev = params.device
    B = len(fills)
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
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    for b, fill in enumerate(fills):
        for start in range(0, fill, T):
            c = min(T, fill - start)
            vecs = pack([(b, start, c)], T,
                         rng.randint(0, cfg.vocab_size, T).astype(np.int32))
            with torch.no_grad():
                M.ragged_step(params, cfg, state, *map(t, vecs), width=T)
    R = 1 + drafts
    tokens = rng.randint(0, cfg.vocab_size, T).astype(np.int32)
    slot, q_pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    seq, valid = np.zeros(T, np.int32), np.zeros(T, bool)
    logit_idx = np.full((B, R), T, np.int32)
    slot[:B], q_pos[:B], valid[:B] = np.arange(B), fills, True
    logit_idx[:, 0] = np.arange(B)
    n = B
    for b, fill in enumerate(fills):
        slot[n:n + drafts], valid[n:n + drafts] = b, True
        q_pos[n:n + drafts] = fill + 1 + np.arange(drafts)
        seq[n:n + drafts] = 1 + np.arange(drafts)
        logit_idx[b, 1:] = n + np.arange(drafts)
        n += drafts
    out = []
    for flash in flashes:
        copy = {"layers": [[{k: v.clone() for k, v in c.items()} for c in ss]
                           for ss in state["layers"]]}
        with torch.no_grad():
            logits, _ = M.ragged_step(
                params, cfg, copy, *map(t, (tokens, slot, q_pos, seq, valid,
                                            logit_idx)),
                width=R, flash_decode=flash)
        assert logits.shape == (B, R, cfg.vocab_size), logits.shape
        out.append(logits.float().cpu())
        del copy
    return out


def paged_route_logits(params, cfg, flashes, *, B, cache_len, page, C, seed):
    """The two-phase path's routes: one (B, C) prefill chunk of a different
    length per slot from a fresh state (gather route), then ONE decode tick
    — every slot but the last decodes, the last rides along invalid with
    its fill count and pages, as a freed slot does — from that same state
    once per entry of ``flashes``
    (each on its own copy of the state).  Returns each run's logits of the
    decoding slots, in order."""
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
    fill = [C - 37 * b for b in range(B)]
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    tokens = rng.randint(0, cfg.vocab_size, (B, C)).astype(np.int32)
    q_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    valid = np.arange(C)[None, :] < np.asarray(fill)[:, None]
    with torch.no_grad():
        M.paged_step(params, cfg, state, t(tokens), t(q_pos), t(valid),
                     with_logits=False)
    tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray(fill, np.int32)[:, None]
    live = (np.arange(B) < B - 1)[:, None]
    out = []
    for flash in flashes:
        copy = {"layers": [[{k: v.clone() for k, v in c.items()} for c in ss]
                           for ss in state["layers"]]}
        with torch.no_grad():
            logits, _ = M.paged_step(params, cfg, copy, t(tok), t(pos), t(live),
                                     flash_decode=flash)
        out.append(logits[:B - 1, 0].float().cpu())
    return out


# ---------------------------------------------------------------------------
# 8. the paper's matmul sweep and memory-mode table


def sweep_phase(card: str) -> int:
    """Figs. 4/5 (both engines, n0 = 16384 float32, nproc 1 to 64) and the
    memory-mode table (8192^3 float32) from ``repro_torch.benchmarks``,
    with the matmul kernel's launches counted from 0.  Every GFLOP/s must
    be positive and finite; returns the launches."""
    from repro_torch.benchmarks import run as bench
    from repro_torch.kernels import matmul as mm

    mm.reset_launches()
    rows = [r for mod in bench.MODULES for r in mod.rows(device="cuda")]
    launches = mm.launches
    by_route = {k: n for k, n in mm.launches_by_route.items() if n}
    print(f"the paper's sweep on {card} (CSV name,us_per_call,derived):")
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
        gf = float(derived.split("GF/s")[0])
        assert math.isfinite(gf) and gf > 0, (name, derived)
    assert launches > 0, "the sweep never launched the matmul kernel"
    # float32 throughout: every launch took a float32 FMA route
    assert sum(by_route.get(r, 0) for r in ("fma_async", "fma_scalar")) == launches, \
        by_route
    print(f"matmul kernel launches in the sweep: {launches}, by route {by_route}")
    return launches


# ---------------------------------------------------------------------------
# 6. full-width training


# the flash kernel's two variants, by their CUDA function names
FLASH_KERNELS = ("flash_attention_kernel", "flash_wgmma_kernel")


def flash_launches_per_step(cfg) -> int:
    """Flash-kernel launches in one training step: one per global attention
    layer in the forward pass; with remat, JAX's nested remat (a group of
    a stage's pattern blocks checkpointed, each block again inside) runs
    each block once more in the backward pass, and the group's
    recomputation, which stops at its last block's input, runs every
    block but the group's last once more again.  Windowed layers take the
    chunked route, as in JAX (tests/test_torch_train.py,
    tests/test_torch_global_theta.py and tests/test_torch_frontends.py
    hold this on the CPU)."""
    if cfg.remat == "none":
        return global_layers(cfg)
    return sum(st.repeats * (2 if i == len(st.pattern) - 1 else 3)
               for st in cfg.stages for i, blk in enumerate(st.pattern)
               if blk.mixer == "attn" and blk.attn.window is None)


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
    fa.reset_launches()  # count only the main path's launches
    hist = loop.run(steps)
    launches = fa.launches
    by_variant = dict(fa.launches_by_variant)
    per_step = flash_launches_per_step(cfg)
    assert launches == per_step * steps, (launches, per_step, steps)
    assert by_variant["wgmma"] == launches, by_variant  # bf16, hd 128
    assert all(np.isfinite(r["loss"]) for r in hist), hist
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = B * shape.seq_len
    n = param_count(cfg)
    print(f"train qwen2-1.5b FULL ({cfg.n_layers} layers, {n / 1e9:.3f} B "
          f"params), seq {shape.seq_len}, batch {B}, bf16 activations, f32 "
          f"params, remat {cfg.remat}, use_flash, on {card}: flash kernel "
          f"launches {launches} = {per_step} per step x {steps} steps, by "
          f"variant {by_variant}; peak "
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
                    if any(k in name for k in FLASH_KERNELS))
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
            if any(k in name for k in FLASH_KERNELS):
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


def train_routes(card: str, arch: str, repeats: int) -> None:
    """``arch`` at full width in f32, its first stage cut to ``repeats``
    repeats of its pattern, batch 1, sequence 4096: ``loss_fn`` and every
    gradient through the flash kernel (``use_flash``) and through the
    chunked route agree, the loss to rtol 1e-4 and every gradient leaf to
    atol 1e-3 x its max |g|."""
    from repro_torch.configs import ShapeCfg, Stage, get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M

    full = get_config(arch)
    cfg = full.replace(dtype="float32",
                       stages=(Stage(full.stages[0].pattern, repeats),))
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda", for_training=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMData(
        cfg, ShapeCfg("route", 4096, 1, "train"), seed=3).batch_at(0).items()}
    leaves = list(params.parameters())
    res = {}
    fa.reset_launches()
    for flash in (True, False):
        loss, _ = M.loss_fn(params, cfg.replace(use_flash=flash), batch)
        res[flash] = (loss.item(), torch.autograd.grad(loss, leaves))
    per_step = flash_launches_per_step(cfg)
    assert fa.launches == fa.launches_by_variant["simt"] == per_step, \
        (fa.launches_by_variant, per_step)  # f32: the simt variant
    (lf, g_flash), (lc, g_chunked) = res[True], res[False]
    np.testing.assert_allclose(lf, lc, rtol=1e-4)
    worst = 0.0
    for name, a, b in zip([n for n, _ in params.named_parameters()], g_flash,
                           g_chunked):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-3 * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")
        worst = max(worst, float((a - b).abs().max()) / max(scale, 1e-30))
    print(f"training, kernel route vs chunked route, {arch} full width f32 "
          f"({cfg.n_layers} layers, {global_layers(cfg)} through the kernel, "
          f"seq 4096, batch 1) on {card}: loss {lf:.6f} vs {lc:.6f}; worst "
          f"gradient leaf max |diff| / max |g| {worst:.3e} over {len(leaves)} "
          f"leaves; flash launches {fa.launches} (simt)")
    del params, res, g_flash, g_chunked
    gc.collect()
    torch.cuda.empty_cache()


# gemma3-4b's training cut: the first 12 layers (10 windowed, 2 global at
# head_dim 256), sequence 4096, batch 1
GEMMA_TRAIN_REPEATS, GEMMA_TRAIN_STEPS = 2, 3


def train_gemma(card: str) -> dict:
    """Phase 6b: gemma3-4b at full width (d 2560, 8 query over 4 KV heads,
    head_dim 256, vocab 262144) cut to its first 12 layers, bf16
    activations over float32 parameters and moments, remat "full",
    ``use_flash``: three ``TrainLoop`` steps at sequence 4096, batch 1.
    Every loss is finite and the flash kernel launches 2 x 2 times a step
    (the two global layers' forward and recomputation), all "simt"."""
    from repro_torch.configs import ShapeCfg, Stage, get_config, param_count
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.loop import TrainLoop

    full = get_config("gemma3-4b")
    cfg = full.replace(use_flash=True, stages=(
        Stage(full.stages[0].pattern, GEMMA_TRAIN_REPEATS),))
    assert cfg.n_layers == 12 and global_layers(cfg) == 2
    steps = GEMMA_TRAIN_STEPS
    loop = TrainLoop(cfg, ShapeCfg("gemma_train", 4096, 1, "train"), lr=3e-4,
                     total_steps=steps, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # count only this path's launches
    hist = loop.run(steps)
    per_step = flash_launches_per_step(cfg)
    assert per_step == 4, per_step
    assert fa.launches == fa.launches_by_variant["simt"] == per_step * steps, \
        (fa.launches_by_variant, per_step, steps)
    assert all(np.isfinite(r["loss"]) for r in hist), hist
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train gemma3-4b FULL width, first {cfg.n_layers} layers "
          f"({global_layers(cfg)} global at head_dim 256), "
          f"{param_count(cfg) / 1e9:.3f} B params, seq 4096, batch 1, bf16 "
          f"activations, f32 params, remat {cfg.remat}, use_flash, on {card}: "
          f"flash kernel launches {fa.launches} = {per_step} per step x "
          f"{steps} steps, by variant {dict(fa.launches_by_variant)}; peak "
          f"memory {peak:.2f} GiB")
    for r in hist:
        print(f"  step {r['step']}: loss {r['loss']:.4f}, "
              f"{1e3 * r['time_s']:.1f} ms, {4096 / r['time_s']:.0f} tokens/s")
    out = dict(launches=fa.launches, step_ms=[1e3 * r["time_s"] for r in hist],
               peak_gib=peak)
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return out


# xlstm-350m's training shape: sequence 1024, batch 1
XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 1024, 3


def train_xlstm(card: str) -> dict:
    """Phase 6c: xlstm-350m FULL (24 layers, d 1024; seed-0 weights) for
    three ``TrainLoop`` steps at sequence 1024, batch 1, bf16 activations
    over float32 parameters and moments, remat "full", no ``use_flash``
    (no attention).  Every loss is finite, and one more ``loss_fn`` gives
    every parameter a finite gradient."""
    from repro_torch.configs import ShapeCfg, get_config, param_count
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainLoop

    cfg = get_config("xlstm-350m")
    steps = XLSTM_TRAIN_STEPS
    shape = ShapeCfg("xlstm_train", XLSTM_TRAIN_SEQ, 1, "train")
    loop = TrainLoop(cfg, shape, lr=3e-4, total_steps=steps, device="cuda",
                     seed=0)
    torch.cuda.reset_peak_memory_stats()
    hist = loop.run(steps)
    assert all(np.isfinite(r["loss"]) for r in hist), hist
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train xlstm-350m FULL ({cfg.n_layers} layers, "
          f"{param_count(cfg) / 1e9:.3f} B params), seq {XLSTM_TRAIN_SEQ}, "
          f"batch 1, bf16 activations, f32 params, remat {cfg.remat}, on "
          f"{card}: peak memory {peak:.2f} GiB")
    for r in hist:
        print(f"  step {r['step']}: loss {r['loss']:.4f}, "
              f"{1e3 * r['time_s']:.1f} ms, "
              f"{XLSTM_TRAIN_SEQ / r['time_s']:.0f} tokens/s")
    params = loop.final_state["params"]
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in loop.data.batch_at(steps).items()}
    leaves = list(params.parameters())
    loss, _ = M.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    names = [n for n, _ in params.named_parameters()]
    missing = [nm for nm, g in zip(names, grads) if g is None]
    assert not missing, f"no gradient reached {missing}"
    bad = [nm for nm, g in zip(names, grads) if not bool(torch.isfinite(g).all())]
    assert not bad, f"non-finite gradients in {bad}"
    print(f"  gradients reach all {len(leaves)} parameter leaves, all finite")
    out = dict(step_ms=[1e3 * r["time_s"] for r in hist], peak_gib=peak)
    del loop, params, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 6d-6f. the frontends, int8 moments and checkpoint/resume


def release() -> None:
    """Collect what the caller dropped and return the cached blocks to the
    card."""
    gc.collect()
    torch.cuda.empty_cache()


def profiled_call(fn, label: str, card: str, top: int = 6) -> None:
    """One more call of ``fn`` (a train or decode step) under
    ``torch.profiler`` (CUDA activity): its wall ms, the device's busy ms
    (kernels and copies), the idle share and the top kernels by device
    time; "not measured" where the profiler recorded no device time."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name, n = {}, 0
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            n += e.count
    busy = sum(by_name.values())
    if busy == 0:
        print(f"  profiled {label} on {card}: {wall:.1f} ms wall, device time "
              f"not measured (no records)")
        return
    print(f"  profiled {label} on {card}: {wall:.1f} ms wall, device busy "
          f"{busy:.1f} ms in {n} kernels and copies, idle share "
          f"{1 - busy / wall:.3f}; top kernels by device time:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:9.3f} ms  {ms / busy:.3f}  {name[:100]}")


HUBERT_TRAIN_SEQ, HUBERT_TRAIN_BATCH, FRONTEND_TRAIN_STEPS = 4096, 2, 3
PREFILL_SEQ = 32768  # prefill_32k


def encoder_flops(cfg, S: int) -> tuple:
    """(projection FLOPs, attention FLOPs) of one forward of an encoder
    over S positions at batch 1: 2 x every matrix's parameters x S, and
    4 x S^2 x head_dim x heads a layer for the bidirectional scores and
    their product with V."""
    from repro_torch.configs import param_count

    proj = 2.0 * param_count(cfg) * S
    attn = sum(4.0 * S * S * blk.attn.head_dim * blk.attn.num_heads * st.repeats
               for st in cfg.stages for blk in st.pattern)
    return proj, attn


def train_hubert(card: str) -> dict:
    """Phase 6d: hubert-xlarge FULL training, then its encoder forward at
    prefill_32k's sequence."""
    from repro_torch.configs import ShapeCfg, get_config, param_count
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainLoop

    cfg = get_config("hubert-xlarge")
    n = param_count(cfg)
    steps, S, B = FRONTEND_TRAIN_STEPS, HUBERT_TRAIN_SEQ, HUBERT_TRAIN_BATCH
    loop = TrainLoop(cfg, ShapeCfg("hubert_train", S, B, "train"), lr=3e-4,
                     total_steps=steps, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    hist = loop.run(steps)
    assert all(np.isfinite(r["loss"]) for r in hist), hist
    peak = torch.cuda.max_memory_allocated() / 2**30
    a = cfg.stages[0].pattern[0].attn
    print(f"train hubert-xlarge FULL ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{a.num_heads} heads at head_dim {a.head_dim}, bidirectional, "
          f"sinusoidal positions, "
          f"{n / 1e9:.3f} B params, {16 * n / 1e9:.1f} GB of float32 "
          f"parameters, gradients and moments), seq {S}, batch {B}, bf16 "
          f"activations, remat {cfg.remat}, on {card}: peak memory "
          f"{peak:.2f} GiB")
    for r in hist:
        t = r["time_s"]
        print(f"  step {r['step']}: loss {r['loss']:.4f}, {1e3 * t:.1f} ms, "
              f"{B * S / t:.0f} tokens/s")
    out = dict(step_ms=[1e3 * r["time_s"] for r in hist], peak_gib=peak)
    state = loop.final_state
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in loop.data.batch_at(steps).items()}
    profiled_call(lambda: loop.step_fn(state, batch), "fourth train step",
                  card)
    del loop, state, batch
    release()

    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")  # bf16 serving layout
    g = torch.Generator("cuda").manual_seed(1)
    with torch.no_grad():
        warm = torch.randn(1, 4096, cfg.d_model // 2, generator=g, device="cuda")
        M.forward(params, cfg, {"feats": warm})  # cuBLAS and allocator warm-up
        feats = torch.randn(1, PREFILL_SEQ, cfg.d_model // 2, generator=g,
                            device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = M.forward(params, cfg, {"feats": feats})
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    assert logits.shape == (1, PREFILL_SEQ, cfg.vocab_size), logits.shape
    assert bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated() / 2**30
    proj, attn = encoder_flops(cfg, PREFILL_SEQ)
    share = (proj + attn) / (ms / 1e3) / BF16_PEAK
    print(f"hubert-xlarge FULL encoder forward at prefill_32k (B 1, S "
          f"{PREFILL_SEQ}, bf16, no grad; bidirectional attention on the "
          f"chunked softmax, q_chunk {cfg.attn_q_chunk}) on {card}: {ms:.1f} ms, "
          f"peak memory {peak:.2f} GiB; {proj / 1e12:.1f} TFLOP of projections "
          f"+ {attn / 1e12:.1f} TFLOP of attention = "
          f"{(proj + attn) / BF16_PEAK * 1e3:.1f} ms at 989 TFLOP/s: "
          f"model-FLOPs share {share:.4f}")
    out.update(prefill_ms=ms, prefill_peak_gib=peak, prefill_share=share)
    del params, logits, feats, warm
    release()
    return out


VISION_B, VISION_CACHE, VISION_PROMPT, VISION_DECODE = 4, 2048, 512, 64
VISION_ROW_RTOL = 5e-2  # bf16 over 40 layers: each logit row within 5 % of its norm


def vision_decode(card: str) -> dict:
    """Phase 6e(a): llama-3.2-vision-11b FULL through the lock-step path."""
    from repro_torch.configs import get_config, param_count
    from repro_torch.models import model as M

    cfg = get_config("llama-3.2-vision-11b")
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    B, L = VISION_B, VISION_PROMPT
    g = torch.Generator("cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (B, L), generator=g, device="cuda")
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device="cuda")
    imgs = [torch.randn(B, cfg.n_img_tokens, cfg.d_model // 2, generator=g,
                        device="cuda") for _ in range(2)]

    def fresh(img):
        state = M.init_decode_state(params, cfg, B, VISION_CACHE, enc_feats=img)
        M.prefill(params, cfg, state, prompt, enc_feats=img)
        return state

    fresh(imgs[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fresh(imgs[0])
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    first, _ = M.decode_step(params, cfg, state, nxt)
    with torch.no_grad():
        full, _ = M.forward(params, cfg, {"tokens": torch.cat([prompt, nxt], 1),
                                          "img_feats": imgs[0]})
    rel = row_rel_err(first[:, 0], full[:, -1])
    assert rel <= VISION_ROW_RTOL, rel
    other, _ = M.decode_step(params, cfg, fresh(imgs[1]), nxt)
    moved = row_rel_err(other[:, 0], first[:, 0])
    assert moved > VISION_ROW_RTOL, moved
    del full, other
    tok = first[:, -1].float().argmax(-1, keepdim=True)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(VISION_DECODE + 1)]
    events[0].record()
    for i in range(VISION_DECODE):
        logits, _ = M.decode_step(params, cfg, state, tok)
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
        events[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(VISION_DECODE)]
    assert int(state["pos"]) == L + 1 + VISION_DECODE
    assert bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated() / 2**30
    profiled_call(lambda: M.decode_step(params, cfg, state, tok),
                  "decode step", card)
    total_s = sum(step_ms) / 1e3
    n = param_count(cfg)
    n_cross = cfg.n_layers - global_layers(cfg)
    print(f"llama-3.2-vision-11b FULL ({cfg.n_layers} layers, {n_cross} "
          f"cross-attention over {cfg.n_img_tokens} image tokens, "
          f"{n / 1e9:.2f} B params, "
          f"{2 * n / 1e9:.1f} GB bf16) lock-step on {card}: B {B}, cache_len "
          f"{VISION_CACHE}, {L}-token prompts: prefill {prefill_ms:.1f} ms; "
          f"{VISION_DECODE} decode steps {np.mean(step_ms):.2f} ms a step "
          f"(median {np.median(step_ms):.2f}, CUDA events), "
          f"{B * VISION_DECODE / total_s:.1f} tokens/s; peak memory {peak:.2f} "
          f"GiB; first step vs forward over prompt + token: max row |diff| / "
          f"|ref| {rel:.3e} (tol {VISION_ROW_RTOL}); other image features "
          f"move it {moved:.3e}")
    out = dict(prefill_ms=prefill_ms, step_ms=float(np.mean(step_ms)),
               peak_gib=peak, rel=rel)
    del params, state, logits, first, imgs
    release()
    return out


def vision_train(card: str) -> dict:
    """Phase 6e(b): llama-3.2-vision-11b's first period trained with float32
    and with int8 moments."""
    from repro_torch.configs import ShapeCfg, Stage, get_config, param_count
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim.adamw import AdamWCfg
    from repro_torch.train.loop import TrainLoop

    full = get_config("llama-3.2-vision-11b")
    cfg = full.replace(use_flash=True,
                       stages=(Stage(full.stages[0].pattern, 1),))
    assert cfg.n_layers == 5 and global_layers(cfg) == 4
    n, steps = param_count(cfg), FRONTEND_TRAIN_STEPS
    per_step = flash_launches_per_step(cfg)
    assert per_step == 4 * 3, per_step  # the self layers precede the cross one
    shape = ShapeCfg("vision_train", 4096, 1, "train")
    out = {}
    for sdt in ("float32", "int8"):
        loop = TrainLoop(cfg, shape, opt_cfg=AdamWCfg(state_dtype=sdt), lr=3e-4,
                         total_steps=steps, device="cuda", seed=0)
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        hist = loop.run(steps)
        launches, by_variant = fa.launches, dict(fa.launches_by_variant)
        assert launches == per_step * steps == by_variant["wgmma"], \
            (by_variant, per_step, steps)
        assert all(np.isfinite(r["loss"]) for r in hist), hist
        peak = torch.cuda.max_memory_allocated() / 2**30
        state = loop.final_state
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in loop.data.batch_at(steps).items()}
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        fa.reset_launches()
        with prof:
            loop.step_fn(state, batch)
            torch.cuda.synchronize()
        instances = sum(e.count for e in prof.key_averages()
                        if "flash_wgmma_kernel" in e.key)
        assert instances in (0, fa.launches) and fa.launches == per_step, \
            (instances, fa.launches, per_step)
        profiled = instances if instances else "not measured (no records)"
        print(f"train llama-3.2-vision-11b's first period ({cfg.n_layers} "
              f"layers: 4 self-attention, 1 cross-attention; {n / 1e9:.3f} B "
              f"params), seq {shape.seq_len}, batch 1, use_flash, {sdt} "
              f"moments, on "
              f"{card}: flash launches {launches} = {per_step} per step x "
              f"{steps}, by variant {by_variant}; a profiled fourth step: "
              f"{fa.launches} launches, flash_wgmma_kernel instances "
              f"{profiled}; peak memory {peak:.2f} GiB")
        for r in hist:
            print(f"  step {r['step']}: loss {r['loss']:.4f}, "
                  f"{1e3 * r['time_s']:.1f} ms, "
                  f"{shape.seq_len / r['time_s']:.0f} tokens/s")
        out[sdt] = dict(losses=[r["loss"] for r in hist], peak_gib=peak,
                        step_ms=[1e3 * r["time_s"] for r in hist])
        del loop, state, batch, prof
        release()
    diff = [abs(a - b) for a, b in zip(out["float32"]["losses"],
                                       out["int8"]["losses"])]
    print(f"  int8 against float32 moments: loss |diff| per step "
          f"{', '.join(f'{d:.3e}' for d in diff)}; peak memory "
          f"{out['int8']['peak_gib']:.2f} vs {out['float32']['peak_gib']:.2f} GiB")
    out["launches"] = per_step * steps
    return out


CKPT_LAYERS, CKPT_SEQ, CKPT_BATCH, CKPT_STEPS = 2, 1024, 2, 8


def checkpoint_phase(card: str) -> dict:
    """Phase 6f: checkpoint/resume and restore-and-replay on the card."""
    from repro_torch.configs import ShapeCfg, Stage, get_config, param_count
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import TrainLoop

    full = get_config("hubert-xlarge")
    cfg = full.replace(stages=(Stage(full.stages[0].pattern, CKPT_LAYERS),))
    shape = ShapeCfg("ckpt", CKPT_SEQ, CKPT_BATCH, "train")

    def loop(d=None, **kw):
        return TrainLoop(cfg, shape, lr=3e-4, total_steps=CKPT_STEPS,
                         device="cuda", seed=0, ckpt_dir=d, **kw)

    straight = [r["loss"] for r in loop().run(CKPT_STEPS)]
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        fails = []

        def once(step):
            if step == 5 and not fails:
                fails.append(step)
                raise RuntimeError("injected failure")

        replay = loop(d, save_every=3, failure_hook=once).run(6)
        assert fails == [5] and [r["step"] for r in replay] == [0, 1, 2, 3, 4, 3, 4, 5]
        resumed_loop = loop(d, save_every=3)
        resumed = resumed_loop.run(CKPT_STEPS)
        assert [r["step"] for r in resumed] == [6, 7]
        got = {r["step"]: r["loss"] for r in replay + resumed}
        got = [got[s] for s in range(CKPT_STEPS)]
        np.testing.assert_allclose(got, straight, rtol=1e-5)
        worst = max(abs(a - b) / abs(b) for a, b in zip(got, straight))
        state = resumed_loop.final_state
        nbytes = sum(t.numel() * t.element_size()
                     for t, _ in ckpt.flatten_state(state).values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer = ckpt.save_checkpoint(d, state, CKPT_STEPS + 1, background=True)
        snap_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        writer.join()
        write_s = time.perf_counter() - t0
        fresh, _ = loop().init_or_restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(d, fresh, step=CKPT_STEPS + 1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for k, (t, _) in ckpt.flatten_state(fresh).items():
            assert torch.equal(t, ckpt.flatten_state(state)[k][0]), k
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"checkpoint/resume, hubert-xlarge full width cut to {CKPT_LAYERS} "
          f"layers ({param_count(cfg) / 1e6:.1f} M params, {nbytes / 1e9:.3f} GB "
          f"of state), seq {CKPT_SEQ}, batch {CKPT_BATCH}, on {card}: {CKPT_STEPS} "
          f"straight steps; a failure at step 5 restored step 3 and replayed; a "
          f"fresh loop resumed at step 6: losses equal the straight run's, max "
          f"relative difference {worst:.3e} (rtol 1e-5); synchronous snapshot "
          f"{snap_ms:.1f} ms, background write {write_s:.2f} s, restore "
          f"{restore_s:.2f} s (exact)")
    del state, fresh
    release()
    return dict(worst=worst, snapshot_ms=snap_ms, write_s=write_s,
                restore_s=restore_s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs import Stage, get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_flash_decode as pfd
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

    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        print(f"[{name}: {time.perf_counter() - phase_t:.1f} s]", flush=True)
        phase_t = time.perf_counter()

    sass_phase(card)
    phase_done("phase 2")
    kres = check_kernel(card)
    dres = check_decode(card)
    fres = check_flash(card)
    mres = check_matmul(card)
    nres = check_rmsnorm(card)
    norm_launches = rmsnorm_route(card)
    check_gemma3_kernels(card)
    phase_done("phase 3")

    full = get_config("qwen2-1.5b")  # full width, bf16 activations
    cfg = cut_depth(full, SERVE_LAYERS)
    params = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    # the main path: the captured ragged engine, bf16 pools, whose first
    # run's replay-aware launch count (from 0) is the kernel's count
    serving = {(True, None): serve_arms(params, cfg, None, card, ragged=True)}
    launches = serving[(True, None)]["captured"]["launches"]
    assert launches > 0, "the serving path never launched the kernel"
    serving[(True, "int8")] = serve_arms(params, cfg, "int8", card, ragged=True)
    del params
    two_cfg = cut_depth(full, TWO_PHASE_LAYERS)
    params = M.init_params(two_cfg,
                           generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    two = serve_arms(params, two_cfg, None, card, ragged=False)["captured"]
    decode_launches = two["launches"]
    assert decode_launches == two_cfg.n_layers * two["decode_ticks"] > 0, \
        (decode_launches, two)
    serve_arms(params, two_cfg, "int8", card, ragged=False)
    del params
    torch.cuda.empty_cache()
    phase_done("phase 4")
    spec_phase(card)
    phase_done("phase 4b")
    tier_phase(card)
    phase_done("phase 4c")
    gemma_phase(card)
    phase_done("phase 4d")
    xlstm_phase(card)
    phase_done("phase 4e")
    llama4_phase(card)
    phase_done("phase 4f")
    jamba_phase(card)
    phase_done("phase 4g")

    cfg32 = full.replace(dtype="float32")
    p32 = M.init_params(cfg32, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    lf, lg = route_logits(p32, cfg32, (True, False), B=8, T=256,
                          cache_len=2048, page=16, seed=2)
    scale = float(lg.abs().max())
    torch.testing.assert_close(lf, lg, rtol=1e-3, atol=1e-3 * scale)
    print(f"kernel route vs gather route, full width f32: max |diff| "
          f"{float((lf - lg).abs().max()):.3e} (max |logit| {scale:.2f})")
    df, dg = paged_route_logits(p32, cfg32, (True, False), B=8,
                                cache_len=2048, page=16, C=512, seed=3)
    scale = float(dg.abs().max())
    torch.testing.assert_close(df, dg, rtol=1e-3, atol=1e-3 * scale)
    print(f"two-phase decode tick, kernel route vs gather route, full width "
          f"f32: max |diff| {float((df - dg).abs().max()):.3e} (max |logit| "
          f"{scale:.2f})")
    del p32
    torch.cuda.empty_cache()
    glm = get_config("glm4-9b")
    glm32 = glm.replace(dtype="float32", stages=(Stage(glm.stages[0].pattern, 4),))
    p32 = M.init_params(glm32, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    vf, vg = verify_route_logits(p32, glm32, (True, False), fills=VERIFY_FILLS,
                                 drafts=SPEC_K, T=256, cache_len=2048, page=16,
                                 seed=4)
    scale = float(vg.abs().max())
    torch.testing.assert_close(vf, vg, rtol=1e-3, atol=1e-3 * scale)
    print(f"verify pack (8 slots x (1 + {SPEC_K}) rows, lens up to 2048), kernel "
          f"route vs gather route, glm4-9b widths f32 (4 layers): logits "
          f"{tuple(vf.shape)}, max |diff| {float((vf - vg).abs().max()):.3e} "
          f"(max |logit| {scale:.2f})")
    del p32
    torch.cuda.empty_cache()
    lockstep_vs_ragged(card)
    phase_done("phase 5")

    tres = train_full(card)
    torch.cuda.empty_cache()
    phase_done("phase 6")
    train_gemma(card)
    phase_done("phase 6b")
    train_xlstm(card)
    phase_done("phase 6c")
    train_hubert(card)
    phase_done("phase 6d")
    vision_decode(card)
    vision_train(card)
    phase_done("phase 6e")
    checkpoint_phase(card)
    phase_done("phase 6f")
    train_routes(card, "qwen2-1.5b", 4)
    train_routes(card, "gemma3-4b", GEMMA_TRAIN_REPEATS)
    phase_done("phase 7")
    sweep_launches = sweep_phase(card)
    phase_done("phase 8")

    t = kres["timings"]["mixed"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, launches, res):
        return {"name": name, **KERNELS[name], "launches": launches,
                "max_abs_err": res["err"], **{k: res[k] for k in keys},
                **({"device_ms": res["device_ms"]} if "device_ms" in res else {})}

    print(card)
    print(json.dumps({"kernels": [
        entry("ragged_paged_flash", launches, {**t, "err": kres["err"],
                                               "library_ms": None}),
        entry("flash_attention", tres["launches"], fres),
        entry("paged_flash_decode", decode_launches, dres),
        entry("rmsnorm", norm_launches, nres[(8192, torch.bfloat16)]),
        entry("matmul", sweep_launches,
              mres[(4096, torch.float32, "vmem")])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
