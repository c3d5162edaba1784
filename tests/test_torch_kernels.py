"""The port's kernel module and pool helpers against the JAX package.

- ``ragged_paged_flash_ref`` (the plain version of the CUDA kernel) against
  the Pallas kernel ``repro.kernels.ops.ragged_paged_flash`` run in
  interpret mode, on the cases of tests/test_kernels.py: mixed packs with
  per-token visible lengths, sentinel block-table pages, ``lens == 0``
  rows (zeros) and int8 pools with fused dequantization.  Tolerance
  rtol = atol = 2e-5 (float32 both sides).
- ``quantize_kv`` / ``dequantize_kv`` / ``kv_scatter_quantized`` /
  ``copy_pages`` against JAX: exact, including sentinel pages and a
  round-half-to-even case.
- ``ragged_variant`` (the wrapper's choice of kernel variant), the C
  entry's variant codes, the split-K geometry and the per-variant counts
  staying 0 on the CPU.
- ``gpu`` tests holding the CUDA kernel against the plain version on packs
  in the engine's order, interleaved, a 40-token run of one slot, a live
  slot followed by slot-0 padding, lens reaching every page, for G 1 and 6,
  hd 64 and 128, page 16 and 32 and every (q, pool) dtype pair, with the
  variant each launch took; and one call under
  ``torch.cuda.set_sync_debug_mode("error")``.  They skip where there is no
  card.

JAX is imported by the ``jax_ops`` fixture, not at module level, so that the
``gpu`` tests also run where only PyTorch is installed.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ragged_paged_flash as rpf  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jax_ops():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops

    return types.SimpleNamespace(jnp=jnp, ops=ops)


def _ragged_case(page, pps, *, B=3, kvH=2, G=4, hd=16, T=11, seed=3):
    """test_kernels.py's ragged pack: slots with different written prefixes
    (unused block-table entries hold the sentinel ``npages``), several
    tokens per slot at increasing visible lengths, an invalid tail."""
    rng = np.random.RandomState(seed)
    npages = B * pps
    kp = rng.standard_normal((npages, page, kvH, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvH, hd)).astype(np.float32)
    q = rng.standard_normal((T, kvH, G, hd)).astype(np.float32)
    perm = rng.permutation(npages)
    ptab = np.full((B, pps), npages, np.int32)
    fills = [pps * page, page + 1, 3]
    for b in range(B):
        used = -(-fills[b] // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    slot = np.asarray([0, 0, 1, 2, 0, 1, 2, 0, 1, 0, 2], np.int32)[:T]
    lens = np.zeros(T, np.int32)
    cursor = {b: 1 for b in range(B)}
    for t in range(T - 1):
        b = int(slot[t])
        lens[t] = min(cursor[b], fills[b])
        cursor[b] += rng.randint(1, 4)
    return q, kp, vp, ptab, slot, lens


def _both(jx, q, kp, vp, ptab, slot, lens, ks=None, vs=None):
    jnp = jx.jnp
    j = jx.ops.ragged_paged_flash(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab),
        jnp.asarray(slot), jnp.asarray(lens),
        ks=None if ks is None else jnp.asarray(ks),
        vs=None if vs is None else jnp.asarray(vs))
    t = rpf.ragged_paged_flash_ref(*(torch.from_numpy(np.array(a)) for a in (
        q, kp, vp, ptab, slot, lens)),
        ks=None if ks is None else torch.from_numpy(np.array(ks)),
        vs=None if vs is None else torch.from_numpy(np.array(vs)))
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("page,pps", [(8, 4), (16, 2)])
def test_ragged_ref_matches_pallas_kernel(jax_ops, page, pps):
    q, kp, vp, ptab, slot, lens = _ragged_case(page, pps)
    assert (ptab == kp.shape[0]).any() and (lens == 0).any()
    j, t = _both(jax_ops, q, kp, vp, ptab, slot, lens)
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_array_equal(t[lens == 0], 0.0)


def test_ragged_ref_int8_fused_dequant_matches_pallas_kernel(jax_ops):
    """int8 pools with their scale rows, against the Pallas kernel's fused
    in-VMEM dequant (test_flash_kernels_fused_dequant_match_fp32_pool)."""
    q, kp, vp, _, _, _ = _ragged_case(8, 3)
    q = q[:5]
    slot = np.asarray([0, 1, 0, 1, 0], np.int32)
    lens = np.asarray([1, 8, 24, 0, 10], np.int32)
    ptab = np.arange(9, dtype=np.int32).reshape(3, 3)[:2]
    kp8, ks = jax_ops.ops.quantize_kv(kp)
    vp8, vs = jax_ops.ops.quantize_kv(vp)
    j, t = _both(jax_ops, q, kp8, vp8, ptab, slot, lens, ks, vs)
    np.testing.assert_allclose(t, j, **TOL)


def _crossing_case(*, kvH=2, G=3, hd=16, page=8, pps=6, seed=7):
    """A 48-token pack whose slot runs cross the kernel's 16-token tile
    boundary and interleave: 20 tokens of slot 0, eight alternating tokens
    of slots 1 and 2, 17 of slot 1, then three invalid tokens of slot 0."""
    rng = np.random.RandomState(seed)
    B = 3
    npages = B * pps
    perm = rng.permutation(npages)
    ptab = np.full((B, pps), npages, np.int32)
    fills = [pps * page, 30, 12]
    for b in range(B):
        used = -(-fills[b] // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    slot = [0] * 20 + [1, 2] * 4 + [1] * 17 + [0] * 3
    lens = (list(range(fills[0] - 19, fills[0] + 1))
            + [10, 3, 11, 5, 12, 8, 13, 12]
            + list(range(14, 31)) + [0, 0, 0])
    q = rng.standard_normal((len(slot), kvH, G, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kvH, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvH, hd)).astype(np.float32)
    return (q, kp, vp, ptab, np.asarray(slot, np.int32),
            np.asarray(lens, np.int32))


def test_ragged_ref_matches_pallas_kernel_on_crossing_runs(jax_ops):
    """Runs longer than a query tile (16 tokens) and interleaved slots: the
    plain version against the Pallas kernel in interpret mode, f32."""
    q, kp, vp, ptab, slot, lens = _crossing_case()
    assert (ptab == kp.shape[0]).any() and (lens == 0).any()
    j, t = _both(jax_ops, q, kp, vp, ptab, slot, lens)
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_array_equal(t[lens == 0], 0.0)


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,aligned,want", [
    (torch.bfloat16, torch.bfloat16, 128, True, "mma"),  # qwen2-1.5b serving
    (torch.bfloat16, torch.int8, 128, True, "mma"),
    (torch.bfloat16, torch.bfloat16, 64, True, "mma"),
    (torch.bfloat16, torch.int8, 64, True, "mma"),
    (torch.bfloat16, torch.float32, 128, True, "simt"),  # no bf16 copy of f32 K
    (torch.bfloat16, torch.bfloat16, 96, True, "simt"),  # no fragment tiling
    (torch.bfloat16, torch.bfloat16, 16, True, "simt"),
    (torch.bfloat16, torch.bfloat16, 128, False, "simt"),  # no 16-byte loads
    (torch.float32, torch.float32, 128, True, "simt"),   # the parity route
    (torch.float32, torch.bfloat16, 128, True, "simt"),
    (torch.float32, torch.int8, 64, True, "simt"),
])
def test_ragged_variant_follows_dtypes_and_head_dim(q_dtype, kv_dtype, hd,
                                                    aligned, want):
    assert rpf.ragged_variant(q_dtype, kv_dtype, hd, aligned) == want


def test_variant_codes_match_the_cuda_source():
    """The wrapper passes ``VARIANTS.index(variant)``; the C entry reads it
    as its ``Variant`` enum."""
    import re

    src = (build.CSRC / "ragged_paged_flash.cu").read_text()
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kSimt": rpf.VARIANTS.index("simt"),
                     "kMma": rpf.VARIANTS.index("mma")}


@pytest.mark.parametrize("S,keys,splits", [
    (2048, 128, 16),   # qwen2-1.5b serving: cache_len 2048
    (32, 128, 1),
    (128, 128, 1),
    (256, 128, 2),
    (4096, 256, 16),
    (32768, 2048, 16),  # long rows: wider splits, never more than 16
    (5000, 320, 16),
])
def test_split_geometry(S, keys, splits):
    assert rpf.split_keys(S) == keys and keys % 64 == 0
    assert rpf.n_splits(S) == splits


def test_cpu_calls_count_no_variant():
    rpf.reset_launches()
    args = [torch.from_numpy(a) for a in _ragged_case(8, 4)]
    for dtype in (torch.float32, torch.bfloat16):
        rpf.ragged_paged_flash(args[0].to(dtype), *args[1:])
    assert rpf.launches == 0 and set(rpf.launches_by_variant.values()) == {0}
    rpf.launches, rpf.launches_by_variant["mma"] = 3, 2
    rpf.reset_launches()
    assert rpf.launches == 0 and set(rpf.launches_by_variant.values()) == {0}


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    """On CPU tensors the wrapper IS the plain version and launches no
    kernel; the counter moves only where the CUDA kernel launches."""
    args = [torch.from_numpy(a) for a in _ragged_case(8, 4)]
    before = rpf.launches
    got = tops.ragged_paged_flash(*args)
    assert rpf.launches == before
    torch.testing.assert_close(got, rpf.ragged_paged_flash_ref(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["lens_dtype", "q_dtype", "pool_shape",
                                 "int8_without_scales", "noncontiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    q, kp, vp, ptab, slot, lens = (torch.from_numpy(a)
                                   for a in _ragged_case(8, 4))
    ks = vs = None
    if bad == "lens_dtype":
        lens = lens.long()
    elif bad == "q_dtype":
        q = q.half()
    elif bad == "pool_shape":
        vp = vp[:, :4]
    elif bad == "int8_without_scales":
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        tops.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)


def test_quantize_kv_matches_jax_including_half_ties(jax_ops):
    """Row [127, .5, 1.5, 2.5, -.5, -1.5, ...]: the scale is exactly 1, so
    the .5 entries are ties, which both sides round half to even."""
    rng = np.random.RandomState(4)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 4
    x[0, 0, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    x[0, 0, 0, 8:] = 0.0
    x[1, 2] = 0.0  # an all-zero row: scale clamps, values stay 0
    jops, jnp = jax_ops.ops, jax_ops.jnp
    jq, js = jops.quantize_kv(jnp.asarray(x))
    tq, ts = tops.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    np.testing.assert_array_equal(
        tops.dequantize_kv(tq, ts).numpy(), np.asarray(jops.dequantize_kv(jq, js)))


def test_kv_scatter_quantized_matches_jax_with_sentinel_pages(jax_ops):
    jops, jnp = jax_ops.ops, jax_ops.jnp
    rng = np.random.RandomState(5)
    n_pages, P, kvH, hd, T = 6, 4, 2, 8, 9
    pool = rng.randint(-127, 128, (n_pages, P, kvH, hd)).astype(np.int8)
    scales = rng.random_sample((n_pages, P, kvH)).astype(np.float32)
    rows = rng.standard_normal((T, kvH, hd)).astype(np.float32)
    # distinct (page, off) targets, with two writes to the sentinel page
    flat = rng.permutation(n_pages * P)[:T]
    page, off = (flat // P).astype(np.int32), (flat % P).astype(np.int32)
    page[[2, 6]] = n_pages
    jp, js = jops.kv_scatter_quantized(jnp.asarray(pool), jnp.asarray(scales),
                                       jnp.asarray(rows), jnp.asarray(page),
                                       jnp.asarray(off))
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    ptr = tp.data_ptr()
    tops.kv_scatter_quantized(tp, ts, torch.from_numpy(rows),
                              torch.from_numpy(page).long(),
                              torch.from_numpy(off).long())
    assert tp.data_ptr() == ptr  # in place
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("scale_pool", [False, True])
def test_copy_pages_matches_jax(jax_ops, scale_pool):
    """A stacked (layers, n_pages, ...) pool, pairs applied in order, and
    sentinel pairs (``n_pages``) that clamp to a no-op self-copy."""
    rng = np.random.RandomState(6)
    L, n_pages, P, kvH, hd = 2, 7, 4, 2, 8
    shape = (L, n_pages, P, kvH) + (() if scale_pool else (hd,))
    pool = rng.standard_normal(shape).astype(np.float32)
    src = np.asarray([1, 4, n_pages, 2], np.int32)
    dst = np.asarray([3, 5, n_pages, 1], np.int32)  # 2->1 after 1->3
    axis = pool.ndim - 3 if scale_pool else None
    jnp = jax_ops.jnp
    j = jax_ops.ops.copy_pages(jnp.asarray(pool), jnp.asarray(src),
                               jnp.asarray(dst), axis=axis)
    t = torch.from_numpy(pool.copy())
    tops.copy_pages(t, src, dst, axis=axis)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_kernel_matches_plain_version(q_dtype, kv_dtype):
    """The hand-written CUDA kernel against ``ragged_paged_flash_ref`` on the
    card.  Tolerance: float32 outputs rtol = atol = 1e-4; bfloat16 outputs
    atol = 2e-2, compared in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, kp, vp, ptab, slot, lens = (torch.from_numpy(a).cuda()
                                   for a in _ragged_case(16, 4, G=6, hd=128))
    ks = vs = None
    if kv_dtype == "int8":
        kp, ks = tops.quantize_kv(kp)
        vp, vs = tops.quantize_kv(vp)
    q = q.to(getattr(torch, q_dtype))
    kp, vp = kp.to(getattr(torch, kv_dtype)), vp.to(getattr(torch, kv_dtype))
    before = rpf.launches
    got = rpf.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert rpf.launches == before + 1
    want = rpf.ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    tol = (dict(rtol=1e-4, atol=1e-4) if q_dtype == "float32"
           else dict(rtol=0.0, atol=2e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert bool((got[lens == 0] == 0).all())


def _gpu_pack(kind, *, G=6, hd=128, page=16, kvH=2, B=4, cache_len=1024,
              seed=11):
    """A pack for the ``gpu`` tests, every unused block-table entry the
    sentinel ``n_pages``; at cache_len 1024 a row is 8 key splits, so rows
    longer than 128 go through the merge kernel.  ``kind``: "engine"
    (decode tokens of slots 0-1, then a 37-token chunk of slot 2 that
    crosses a split boundary and a 20-token chunk of slot 3, then slot-0
    padding with lens 0, as ServeEngine packs); "interleaved" (random slots
    in random order); "run40" (40 tokens of one slot); "padding" (one live
    slot 2, five tokens, then slot-0 padding); "full" (one token of each
    slot at lens = cache_len, every page)."""
    rng = np.random.RandomState(seed)
    pps = cache_len // page
    n_pages = B * pps
    if kind == "engine":
        slot = [0, 1] + [2] * 37 + [3] * 20
        lens = [cache_len - 7, 90] + list(range(240, 277)) + list(range(1, 21))
    elif kind == "interleaved":
        slot = rng.randint(0, B, 50).tolist()
        lens = rng.randint(1, cache_len + 1, 50).tolist()
    elif kind == "run40":
        slot = [1] * 40
        lens = list(range(cache_len - 39, cache_len + 1))
    elif kind == "padding":
        slot = [2] * 5
        lens = list(range(100, 105))
    else:
        slot = list(range(B))
        lens = [cache_len] * B
    T = 64
    slot += [0] * (T - len(slot))
    lens += [0] * (T - len(lens))
    ptab = np.full((B, pps), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    for b in range(B):
        used = -(-max([l for l, s in zip(lens, slot) if s == b] + [0]) // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    normal = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return (normal(T, kvH, G, hd), normal(n_pages, page, kvH, hd),
            normal(n_pages, page, kvH, hd), i32(ptab), i32(slot), i32(lens))


def _gpu_check(pack, q_dtype, kv_dtype):
    """Launch the kernel on ``pack`` in the given types; hold it against the
    plain version.  Tolerance: float32 outputs rtol = atol = 1e-4; bfloat16
    outputs atol 2e-2 and each output row within 1e-2 of its norm, compared
    in float32.  ``lens == 0`` rows exactly zero; one launch, through the
    variant ``ragged_variant`` names."""
    q, kp, vp, ptab, slot, lens = (t.cuda() for t in pack)
    ks = vs = None
    if kv_dtype == "int8":
        kp, ks = tops.quantize_kv(kp)
        vp, vs = tops.quantize_kv(vp)
    q = q.to(getattr(torch, q_dtype))
    kp, vp = kp.to(getattr(torch, kv_dtype)), vp.to(getattr(torch, kv_dtype))
    rpf.reset_launches()
    got = rpf.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    torch.cuda.synchronize()
    variant = rpf.ragged_variant(q.dtype, kp.dtype, q.shape[-1])
    assert rpf.launches == rpf.launches_by_variant[variant] == 1
    want = rpf.ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    if q_dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
        d = (got.float() - want.float()).norm(dim=-1)
        assert bool((d <= 1e-2 * want.float().norm(dim=-1)).all())
    assert bool((got[lens == 0] == 0).all())


_DTYPE_PAIRS = [(q, kv) for q in ("float32", "bfloat16")
                for kv in ("float32", "bfloat16", "int8")]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", _DTYPE_PAIRS)
@pytest.mark.parametrize("kind", ["engine", "interleaved", "run40", "padding",
                                  "full"])
def test_cuda_kernel_on_pack_kinds(kind, q_dtype, kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _gpu_check(_gpu_pack(kind), q_dtype, kv_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", _DTYPE_PAIRS)
@pytest.mark.parametrize("G,hd,page", [(g, h, p) for g in (1, 6)
                                       for h in (64, 128) for p in (16, 32)])
def test_cuda_kernel_on_shapes(G, hd, page, q_dtype, kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _gpu_check(_gpu_pack("engine", G=G, hd=hd, page=page), q_dtype, kv_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cuda_kernel_makes_no_host_synchronisation(kv_dtype):
    """The wrapper's grid and scratch follow from shapes: no ``.item()``,
    ``.cpu()`` or ``.tolist()`` of a device tensor.  Under sync debug mode
    "error" any such call raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, kp, vp, ptab, slot, lens = (t.cuda() for t in _gpu_pack("engine"))
    ks = vs = None
    if kv_dtype == "int8":
        kp, ks = tops.quantize_kv(kp)
        vp, vs = tops.quantize_kv(vp)
    dt = getattr(torch, kv_dtype)
    q, kp, vp = q.bfloat16(), kp.to(dt), vp.to(dt)
    rpf.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rpf.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = rpf.ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
