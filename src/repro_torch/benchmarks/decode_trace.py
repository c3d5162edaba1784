"""Where the two-phase decode kernel's time goes: a per-block phase trace.

    PYTHONPATH=src python -m repro_torch.benchmarks.decode_trace [--split-keys 64 128 256]

Needs a CUDA card.  Builds a copy of ``csrc/paged_flash_decode.cu`` in
which thread 0 of every block of the ``mma`` variant writes the device's
``%globaltimer`` (ns) at six points: kernel entry; after the block read its
slot's length and block-table entries ("begin"); when the first K/V step
has landed ("first K/V"); after the key loop ("loop"); after the split's
partial was written and its ticket drawn ("partial + ticket"); after the
merge of the last split ("merge") or the direct write of a slot that fits
one split ("direct").  It runs the traced kernel, warm, on ``chip_smoke.py``'s
phase-3 decode tick (8 slots at lens 2048, 1500, 1101, 701, 421, 201, 65
and 0; qwen2-1.5b's heads: kvH 2, G 6, hd 128; page 16; bf16 q over bf16
and int8 pools) and prints, for each split size, each phase's median and
largest duration over the blocks that ran it and the kernel's span from
the first block's entry to the last block's end.  The traced library is
built under ``build/kernels/`` and is used only inside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops
from repro_torch.kernels import paged_flash_decode as pfd

PHASES = ("entry", "begin", "first K/V", "loop", "partial + ticket", "merge",
          "direct")

_TRACE = '''#include "paged.cuh"
__device__ unsigned long long g_trace[8192][8];
#define STAMP(k)                                                                  \\
  do {                                                                            \\
    if (threadIdx.x == 0) {                                                       \\
      unsigned long long t;                                                       \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                       \\
      g_trace[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x][k] = t; \\
    }                                                                             \\
  } while (0)
extern "C" int read_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
extern "C" int clear_trace() {
  void* a;
  cudaGetSymbolAddress(&a, g_trace);
  return (int)cudaMemset(a, 0, sizeof(g_trace));
}
'''

# (anchor in the source, what replaces it): each anchor must occur as often
# as given, or the source changed and the trace points need a new look
_POINTS = [
    ('#include "paged.cuh"\n', _TRACE, 1),
    ("  Split sp;\n  if (!begin_split(p, sp, pg_s, &len_s)) return;\n",
     "  Split sp;\n  STAMP(0);\n  if (!begin_split(p, sp, pg_s, &len_s)) return;\n"
     "  STAMP(1);\n", 2),
    ("    if (s == 0) {\n", "    if (s == 0) {\n      STAMP(2);\n", 1),
    ("  __syncthreads();\n  finish<__nv_bfloat16>",
     "  STAMP(3);\n  __syncthreads();\n  finish<__nv_bfloat16>", 1),
    ("  __syncthreads();\n  if (!fs.last) return;\n",
     "  __syncthreads();\n  STAMP(4);\n  if (!fs.last) return;\n", 1),
    ("    merge_columns<QT, float>(p, sp, ns, plane, fs);\n}\n",
     "    merge_columns<QT, float>(p, sp, ns, plane, fs);\n  STAMP(5);\n}\n", 1),
    ("combined(r, d) * fs.inv[r]);\n    }\n    return;\n",
     "combined(r, d) * fs.inv[r]);\n    }\n    STAMP(6);\n    return;\n", 1),
]


def traced_source() -> str:
    src = (build.CSRC / "paged_flash_decode.cu").read_text()
    for anchor, repl, count in _POINTS:
        if src.count(anchor) != count:
            raise RuntimeError(f"trace point not found {count} times: {anchor!r}")
        src = src.replace(anchor, repl)
    return src


def build_traced() -> ctypes.CDLL:
    """Compile the traced copy beside the real source (it includes
    ``paged.cuh``) into build/kernels/ and load it."""
    cu = build.CSRC / "_paged_flash_decode_traced.cu"
    so = build.BUILD_DIR / "paged_flash_decode_traced.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu.write_text(traced_source())
    try:
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True, text=True)
    finally:
        cu.unlink()
    return ctypes.CDLL(str(so))


@contextlib.contextmanager
def through(lib):
    """``paged_flash_decode`` launches ``lib``'s kernel inside the block."""
    fn = lib.paged_flash_decode
    fn.argtypes = pfd._lib().argtypes
    fn.restype = ctypes.c_int
    real = pfd._lib
    pfd._lib = lambda: fn
    try:
        yield
    finally:
        pfd._lib = real


def decode_tick(kv_dtype, *, seed=0):
    """chip_smoke.py's phase-3 decode tick on the card, bf16 q:
    (q, kp, vp, ptab, lens, ks, vs)."""
    rng = np.random.RandomState(seed)
    B, kvH, G, hd, page, cache_len = 8, 2, 6, 128, 16, 2048
    pps = cache_len // page
    n_pages = B * pps
    lens = np.asarray([cache_len, 1500, 1101, 701, 421, 201, 65, 0], np.int32)
    perm = rng.permutation(n_pages)
    ptab = np.full((B, pps), n_pages, np.int32)
    for b in range(B):
        used = -(-int(lens[b]) // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    normal = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).cuda()
    q = normal(B, kvH, G, hd)
    kp = normal(n_pages, page, kvH, hd)
    vp = normal(n_pages, page, kvH, hd)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp, ks = ops.quantize_kv(kp)
        vp, vs = ops.quantize_kv(vp)
    return (q.bfloat16(), kp.to(kv_dtype), vp.to(kv_dtype),
            torch.from_numpy(ptab).cuda(), torch.from_numpy(lens).cuda(), ks, vs)


def trace_once(lib, args, split_keys: int) -> dict:
    """One warm traced launch at ``split_keys``: {phase: (median us, max
    us, blocks)} and the span in us."""
    q, kp, vp, ptab, lens, ks, vs = args
    default = pfd.SPLIT_KEYS
    pfd.SPLIT_KEYS = split_keys
    try:
        call = lambda: pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)  # noqa: E731
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        lib.clear_trace()
        call()
        torch.cuda.synchronize()
        n_blocks = pfd.n_splits(ptab.shape[1] * kp.shape[1]) * q.shape[1] * q.shape[0]
    finally:
        pfd.SPLIT_KEYS = default
    tr = np.zeros((8192, 8), np.uint64)
    lib.read_trace(tr.ctypes.data_as(ctypes.c_void_p))
    tr = tr[:n_blocks].astype(np.int64)
    t0 = tr[tr[:, 0] > 0, 0].min()
    # (phase, stamp it ends at, stamp it starts from)
    spans = [("begin", 1, 0), ("first K/V", 2, 1), ("loop", 3, 2),
             ("partial + ticket", 4, 3), ("merge", 5, 4), ("direct", 6, 3)]
    out = {}
    for name, end, start in spans:
        ran = (tr[:, end] > 0) & (tr[:, start] > 0)
        d = (tr[ran, end] - tr[ran, start]) / 1e3
        out[name] = (float(np.median(d)), float(d.max()), int(ran.sum())) if ran.any() else None
    last = tr[:, 1:].max(axis=1)
    out["span"] = float((last.max() - t0) / 1e3)
    out["blocks"] = (int((tr[:, 0] > 0).sum()), int((tr[:, 1] > 0).sum()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split-keys", type=int, nargs="+", default=[64, 128, 256])
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_trace needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    lib = build_traced()
    with through(lib):
        for kv_dtype in (torch.bfloat16, torch.int8):
            args = decode_tick(kv_dtype)
            for keys in a.split_keys:
                r = trace_once(lib, args, keys)
                print(f"decode trace, pools {kv_dtype}, {keys}-key splits, on "
                      f"{card}: {r['blocks'][0]} blocks, {r['blocks'][1]} with "
                      f"work; span {r['span']:.2f} us")
                for name in PHASES[1:]:
                    v = r[name]
                    if v is not None:
                        print(f"  {name:17s} median {v[0]:6.2f} us, max {v[1]:6.2f} "
                              f"us over {v[2]} blocks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
