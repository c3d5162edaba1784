"""The port's causal flash attention against the JAX package, and the
kernel build helpers.

- ``flash_attention`` on CPU tensors (its plain version) against the Pallas
  kernel ``repro.kernels.ops.flash_attention`` run in interpret mode, on the
  cases of tests/test_kernels.py (S / hd / G / kvH / window sweeps in
  float32 and bfloat16, block invariance, causality).  Tolerance: float32
  rtol = atol = 1e-5 (the two sum in another order; a failure also prints
  each side's distance from a float64 yardstick, the thread count, the
  affinity and the CPU, since one such failure under load never came
  back); bfloat16 atol = 2e-2,
  compared in float32 (p is rounded to bf16 against another running max),
  and each output row within 1e-2 of its norm.
- ``flash_attention_grouped`` forward and its gradients (q, k, v) against
  JAX's custom-VJP version at float32, rtol = atol = 1e-4.
- ``kernels.build``: the library name's hash follows the source, and
  ``build_all`` runs one compiler per source at once and reports the
  failing source's output (with a stand-in compiler, as there is no nvcc).
- ``flash_variant``, the wrapper's choice of kernel variant from dtype and
  head_dim, for each branch; its order of variants against the C source's
  enum; the per-variant counts stay 0 on the CPU.
- ``gpu`` tests holding the CUDA kernel's two variants against the plain
  version, with the per-variant launch counts; they skip where there is no
  card.

JAX is imported by the ``jx`` fixture, not at module level, so that the
``gpu`` tests also run where only PyTorch is installed.  The module runs
torch on one intra-op thread (``one_torch_thread``), as the serving parity
files do.
"""
import os
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.0, atol=2e-2)
BF16_ROW_RTOL = 1e-2


def _f64_attention(q, k, v, window):
    """Causal attention in float64 (numpy), shapes as ``flash_attention``:
    the yardstick a failing float32 comparison measures each side by."""
    BH, S, hd = q.shape
    BKV = k.shape[0]
    qf = q.astype(np.float64).reshape(BKV, BH // BKV, S, hd) * hd ** -0.5
    s = np.einsum("kgqd,ktd->kgqt", qf, k.astype(np.float64))
    rows, cols = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = rows >= cols
    if window is not None:
        ok &= (rows - cols) < window
    p = np.exp(np.where(ok, s, -np.inf) - np.where(ok, s, -np.inf).max(
        -1, keepdims=True))
    o = np.einsum("kgqt,ktd->kgqd", p, v.astype(np.float64))
    return (o / p.sum(-1, keepdims=True)).reshape(BH, S, hd)


def _cpu_info() -> str:
    """The CPU model and its widest vector ISA, from the Linux CPU table
    (empty elsewhere)."""
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read()
    except OSError:
        return "cpu unknown"
    model = next((ln.split(":", 1)[1].strip() for ln in text.splitlines()
                  if ln.startswith("model name")), "unknown")
    flags = next((ln.split(":", 1)[1].split() for ln in text.splitlines()
                  if ln.startswith("flags")), [])
    isa = next((f for f in ("avx512f", "avx2", "avx") if f in flags), "none")
    return f"cpu {model!r}, {isa}"


def assert_f32_close(got, want, arrays, window):
    """``F32_TOL``.  A failure also reports each side's max |diff| from a
    float64 yardstick on the same inputs (which side moved), torch's
    intra-op threads, the process's CPU affinity, the CPU, and the test
    worker: a failure that does not come back still says where it was."""
    got, want = np.asarray(got), np.asarray(want)
    try:
        np.testing.assert_allclose(got, want, **F32_TOL)
    except AssertionError as err:
        ref = _f64_attention(*arrays, window)
        diag = (f"max |port - float64| {np.abs(got - ref).max():.3e}, "
                f"max |jax - float64| {np.abs(want - ref).max():.3e}; torch "
                f"threads {torch.get_num_threads()}, affinity "
                f"{len(os.sched_getaffinity(0))} of {os.cpu_count()} CPUs, "
                f"{_cpu_info()}, worker "
                f"{os.environ.get('PYTEST_XDIST_WORKER', 'main')}")
        raise AssertionError(f"{err}\n{diag}") from None


def assert_bf16_close(got, want):
    """Each element to ``BF16_TOL``, and each output row (one query row of
    one head) to ``BF16_ROW_RTOL`` of its norm: the long causal rows, which
    hold small values, are held relative to their own size."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, **BF16_TOL)
    rel = (np.linalg.norm(got - want, axis=-1)
           / np.maximum(np.linalg.norm(want, axis=-1), 1e-30))
    assert rel.max() <= BF16_ROW_RTOL, rel.max()


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ops)


def _qkv(BH, BKV, S, hd, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((BH, S, hd), (BKV, S, hd), (BKV, S, hd)))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(jx, arrays, dtype="float32"):
    return [jx.jnp.asarray(a, getattr(jx.jnp, dtype)) for a in arrays]


@pytest.mark.parametrize("S,hd,G,kvH", [(64, 16, 1, 2), (64, 32, 4, 2),
                                        (128, 16, 2, 3)])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(jx, S, hd, G, kvH, window, dtype):
    B = 2
    arrays = _qkv(B * kvH * G, B * kvH, S, hd)
    want = jx.ops.flash_attention(*_jax(jx, arrays, dtype), bq=32, bk=32,
                                  window=window)
    got = tops.flash_attention(*_torch(arrays, getattr(torch, dtype)), bq=32,
                               bk=32, window=window)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert_f32_close(got.numpy(), want, arrays, window)
    else:
        assert_bf16_close(got.float().numpy(), want)


def test_block_invariance(jx):
    arrays = _qkv(4, 2, 128, 16, seed=1)
    for bq, bk in ((16, 64), (128, 16)):
        want = jx.ops.flash_attention(*_jax(jx, arrays), bq=bq, bk=bk)
        got = tops.flash_attention(*_torch(arrays), bq=bq, bk=bk)
        assert_f32_close(got.numpy(), want, arrays, None)


@pytest.mark.parametrize("sq,hd,g", [(32, 8, 1), (64, 16, 3), (64, 8, 2)])
def test_causality(sq, hd, g):
    """Output at position t is unaffected by future K/V."""
    q, k, v = _torch(_qkv(g, 1, sq, hd, seed=2))
    o1 = tops.flash_attention(q, k, v, bq=16, bk=16)
    t = sq // 2
    k2, v2 = k.clone(), v.clone()
    k2[:, t + 1:] = 99.0
    v2[:, t + 1:] = -99.0
    o2 = tops.flash_attention(q, k2, v2, bq=16, bk=16)
    torch.testing.assert_close(o1[:, :t + 1], o2[:, :t + 1], rtol=1e-5, atol=1e-5)


def _grouped_case(B=2, S=64, kvH=2, G=3, hd=16, seed=3):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, S, kvH, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kvH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kvH, hd)).astype(np.float32)
    w = rng.standard_normal((B, S, kvH, G, hd)).astype(np.float32)
    return q, k, v, w


def test_grouped_forward_matches_jax(jx):
    q, k, v, _ = _grouped_case()
    want = jx.ops.flash_attention_grouped(*_jax(jx, (q, k, v)))
    got = tops.flash_attention_grouped(*_torch((q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_grouped_gradients_match_jax(jx):
    """d/d(q,k,v) of sum(o * w): the kernel forward, then the VJP of the
    chunked reference, on both sides."""
    q, k, v, w = _grouped_case(S=256)  # two 128-query chunks in _ref_grouped
    jnp = jx.jnp

    def jloss(q, k, v):
        return jnp.sum(jx.ops.flash_attention_grouped(q, k, v) * jnp.asarray(w))

    want = jx.jax.grad(jloss, argnums=(0, 1, 2))(*_jax(jx, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _torch((q, k, v)))
    (tops.flash_attention_grouped(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    args = _torch(_qkv(6, 2, 64, 16))
    before = fa.launches
    got = fa.flash_attention(*args, window=8)
    assert fa.launches == before
    torch.testing.assert_close(got, fa.flash_attention_ref(*args, window=8),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype_mix", "half", "groups", "tiling",
                                 "window", "noncontiguous", "kv_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = _torch(_qkv(6, 2, 64, 16))
    kw = {}
    if bad == "dtype_mix":
        k = k.bfloat16()
    elif bad == "half":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "groups":
        k, v = _torch(_qkv(4, 4, 64, 16))[1:]
    elif bad == "tiling":
        kw = dict(bq=48)
    elif bad == "window":
        kw = dict(window=0)
    elif bad == "noncontiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        v = v[:, :32]
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# the variant choice (pure Python)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "wgmma"),   # qwen2-1.5b's training path
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 96, "simt"),     # no TMA box / wgmma tile for it
    (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 256, "simt"),    # gemma3-4b's global layers
    (torch.float32, 256, "simt"),
    (torch.float32, 128, "simt"),     # the parity route: no TF32
    (torch.float32, 64, "simt"),
])
def test_flash_variant_follows_dtype_and_head_dim(dtype, hd, want):
    assert fa.flash_variant(dtype, hd) == want


def test_variant_codes_match_the_cuda_source():
    """The wrapper passes ``VARIANTS.index(variant)``; the C entry reads it
    as its ``Variant`` enum."""
    import re

    src = (build.CSRC / "flash_attention.cu").read_text()
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kSimt": fa.VARIANTS.index("simt"),
                     "kWgmma": fa.VARIANTS.index("wgmma")}


def test_cpu_calls_count_no_variant():
    fa.reset_launches()
    assert fa.launches == 0 and set(fa.launches_by_variant.values()) == {0}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _torch(_qkv(6, 2, 64, 64), dtype)
        fa.flash_attention(q, k, v, bq=32, bk=32)
    assert fa.launches == 0 and set(fa.launches_by_variant.values()) == {0}
    fa.launches, fa.launches_by_variant["wgmma"] = 3, 2
    fa.reset_launches()
    assert fa.launches == 0 and set(fa.launches_by_variant.values()) == {0}


# ---------------------------------------------------------------------------
# kernels/build.py (no nvcc here: a stand-in compiler script)


def test_library_path_hash_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    src.write_text("// two\n")
    assert build.library_path("k") != first
    assert build.library_path("k").parent == build.BUILD_DIR


FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) src="$1"; shift;; esac
done
name=$(basename "$src" .cu)
touch "{d}/started_$name"
if [ "$name" = a ]; then  # finishes only if b's compiler runs meanwhile
  i=0
  while [ ! -f "{d}/started_b" ] && [ $i -lt 200 ]; do sleep 0.05; i=$((i+1)); done
  [ -f "{d}/started_b" ] || {{ echo "b was not started alongside a"; exit 1; }}
fi
if [ "$name" = bad ]; then echo "bad.cu(3): error: expected a ';'"; exit 2; fi
echo "ptxas info : Used 40 registers ($name)"
: > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(d=tmp_path))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    return tmp_path


def test_build_all_compiles_sources_concurrently(fake_nvcc):
    logs = build.build_all(["a", "b"])
    assert set(logs) == {"a", "b"}
    assert "40 registers (a)" in logs["a"] and "(b)" in logs["b"]
    assert build.library_path("a").exists() and build.library_path("b").exists()
    (fake_nvcc / "started_a").unlink()
    assert build.build_all(["a"]) == {"a": logs["a"]}  # built: not compiled again
    assert not (fake_nvcc / "started_a").exists()


def test_build_all_raises_with_the_failing_sources_output(fake_nvcc):
    with pytest.raises(RuntimeError, match=r"bad\.cu(.|\n)*expected a ';'"):
        build.build_all(["b", "bad"])
    assert build.library_path("b").exists()  # the good source still built
    assert not build.library_path("bad").exists()


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,G,window", [(96, 3, None), (256, 6, None),
                                        (256, 2, 40)])
def test_cuda_kernel_matches_plain_version(dtype, S, G, window):
    """The hand-written CUDA kernel against ``flash_attention_ref`` on the
    card (hd 128, two KV rows).  Tolerance: float32 rtol = atol = 1e-4;
    bfloat16 as ``assert_bf16_close``, compared in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (t.cuda() for t in _torch(_qkv(2 * G, 2, S, 128, seed=5),
                                        getattr(torch, dtype)))
    before = fa.launches
    by_variant = dict(fa.launches_by_variant)
    got = fa.flash_attention(q, k, v, bq=32, bk=32, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    variant = "simt" if dtype == "float32" else "wgmma"
    assert fa.launches_by_variant == {**by_variant, variant: by_variant[variant] + 1}
    want = fa.flash_attention_ref(q, k, v, window)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [96, 256, 1024])
@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("window", [None, 40, 512])
def test_cuda_wgmma_variant_matches_plain_version(hd, S, G, window):
    """The "wgmma" variant (bf16, hd 64 and 128; S 96 is not a multiple of
    its 64-key tiles, so TMA zero-fills past S) against
    ``flash_attention_ref``, tolerance as ``assert_bf16_close``; only its
    own launch count moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (t.cuda() for t in _torch(_qkv(2 * G, 2, S, hd, seed=S + hd),
                                        torch.bfloat16))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches_by_variant == {"wgmma": 1, "simt": 0}
    want = fa.flash_attention_ref(q, k, v, window)
    assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [("float32", 64), ("float32", 128),
                                      ("bfloat16", 32), ("bfloat16", 96)])
def test_cuda_simt_variant_matches_plain_version(dtype, hd):
    """float32 stays on the float32-FMA variant (TF32 would change the
    result), and so does bf16 at a head_dim the wgmma variant does not
    take: only the simt count moves.  Tolerance: float32 rtol = atol =
    1e-4; bfloat16 as ``assert_bf16_close``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (t.cuda() for t in _torch(_qkv(12, 2, 256, hd, seed=hd),
                                        getattr(torch, dtype)))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, window=40)
    torch.cuda.synchronize()
    assert fa.launches_by_variant == {"wgmma": 0, "simt": 1}
    want = fa.flash_attention_ref(q, k, v, 40)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,window", [(256, None), (256, 512), (200, None),
                                       (200, 512)])
def test_cuda_simt_variant_past_head_dim_128(dtype, hd, window):
    """head_dim above 128 on the "simt" variant (its accumulator takes one
    4-column group per 64 columns, four at hd 256): gemma3-4b's global
    layers' 256, and 200, whose last group is an eighth full; G 2 (8 query
    rows over 4 KV rows), S 1024, causal, and a 512-key window.
    Tolerance: float32 rtol = atol = 1e-4; bfloat16 as
    ``assert_bf16_close``; only the simt count moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (t.cuda() for t in _torch(_qkv(8, 4, 1024, hd, seed=hd),
                                        getattr(torch, dtype)))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches_by_variant == {"wgmma": 0, "simt": 1}
    want = fa.flash_attention_ref(q, k, v, window)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.gpu
def test_cuda_kernel_refuses_head_dim_past_256():
    """264 (a multiple of 8 past the kernel's 256) raises before any
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (t.cuda() for t in _torch(_qkv(2, 1, 64, 264)))
    fa.reset_launches()
    with pytest.raises(ValueError, match="up to 256"):
        fa.flash_attention(q, k, v)
    assert fa.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 3])
def test_cuda_kernel_on_a_model_ranks_heads(dtype, n):
    """The training kernel under ``heads_tp`` at 'model' n: each rank's
    call on its G/n query heads (the G slice of ``wq``'s spec under a
    (1, n) ``MeshView``) over the whole k and v equals those heads of the
    whole call bitwise (batch 2, sequence 256, kvH 2, G 6, hd 128, causal;
    bf16 runs the "wgmma" variant, float32 the "simt")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.parallel.sharding import (PARAM_AXES, MeshView,
                                               local_slices, logical_spec,
                                               make_rules, sanitize_spec)

    B, S, kvH, G, hd = 2, 256, 2, 6, 128
    g = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn(shape, generator=g).to(getattr(torch, dtype)).cuda()
               for shape in ((B, S, kvH, G, hd), (B, S, kvH, hd),
                             (B, S, kvH, hd)))
    fa.reset_launches()
    whole = tops.flash_attention_grouped(q, k, v)
    wq = (64, kvH, G, hd)
    for r in range(n):
        view = MeshView((1, n), ("data", "model"), (0, r))
        spec = sanitize_spec(logical_spec(PARAM_AXES["wq"],
                                          make_rules(view, heads_tp=True)),
                             wq, view)
        heads = local_slices(spec, wq, view)[2]
        assert heads.stop - heads.start == G // n, heads
        share = tops.flash_attention_grouped(q[:, :, :, heads].contiguous(), k, v)
        assert torch.equal(share, whole[:, :, :, heads]), (r, heads)
    variant = "simt" if dtype == "float32" else "wgmma"
    assert fa.launches_by_variant[variant] == fa.launches == n + 1
