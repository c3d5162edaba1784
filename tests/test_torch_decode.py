"""The two-phase decode kernel's geometry on the CPU, and the kernel itself
on the card.

- ``kernel_variant`` (the wrapper's choice of kernel variant: the serving
  kernel's rule over dtypes, head_dim and 16-byte alignment), the split
  geometry (``split_keys``, ``n_splits``), the shapes ``check_kernel_fits``
  refuses, and the per-variant counts staying 0 on the CPU.
- ``gpu`` tests holding the CUDA kernel against ``paged_flash_decode_ref``
  for every (q, pool) dtype pair: lens at 0, 1, KS - 1, KS, KS + 1, 2 KS + 5
  and the full row (KS = the split's keys), so that one split, several
  splits and their merge all run; G in {1, 4, 6, 8, 20}, head_dim in {64,
  128, 80 ("simt")}, page in {8, 16, 32}; two calls in a row agree exactly
  (the split counters reset themselves); one call under
  ``torch.cuda.set_sync_debug_mode("error")``; and the kernel against
  ``ragged_paged_flash`` with one token per slot.  Tolerance: float32
  outputs rtol = atol = 1e-4; bfloat16 outputs atol 2e-2 and each output row
  within 1e-2 of its norm, compared in float32.  They skip where there is no
  card.

The plain version's parity with the Pallas kernel is held in
tests/test_torch_paged.py.  This file does not import JAX.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_flash_decode as pfd  # noqa: E402
from repro_torch.kernels import ragged_paged_flash as rpf  # noqa: E402

BF16_ROW_RTOL = 1e-2


def _aligned(shape, dtype, offset=0):
    """A contiguous CPU tensor whose data starts ``offset`` elements into a
    fresh buffer (offset 1 of a 2-byte type: not 16-byte aligned)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,offset,want", [
    (torch.bfloat16, torch.bfloat16, 128, 0, "mma"),  # qwen2-1.5b serving
    (torch.bfloat16, torch.int8, 128, 0, "mma"),
    (torch.bfloat16, torch.bfloat16, 64, 0, "mma"),
    (torch.bfloat16, torch.int8, 64, 0, "mma"),
    (torch.bfloat16, torch.bfloat16, 80, 0, "simt"),  # no fragment tiling
    (torch.bfloat16, torch.float32, 128, 0, "simt"),  # no bf16 copy of f32 K
    (torch.bfloat16, torch.bfloat16, 128, 1, "simt"),  # no 16-byte loads
    (torch.float32, torch.float32, 128, 0, "simt"),   # the parity route
    (torch.float32, torch.bfloat16, 128, 0, "simt"),
    (torch.float32, torch.int8, 64, 0, "simt"),
])
def test_kernel_variant_follows_dtypes_head_dim_and_alignment(q_dtype, kv_dtype,
                                                              hd, offset, want):
    q = _aligned((3, 2, 6, hd), q_dtype, offset)
    kp = _aligned((4, 16, 2, hd), kv_dtype)
    vp = _aligned((4, 16, 2, hd), kv_dtype)
    assert pfd.kernel_variant(q, kp, vp) == want
    assert want == rpf.ragged_variant(q_dtype, kv_dtype, hd, offset == 0)


def test_variant_names_and_codes_are_the_serving_kernels():
    """The wrapper passes ``VARIANTS.index(variant)``; the C entry reads it
    as its ``Variant`` enum, which both serving kernels number alike."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "paged_flash_decode.cu").read_text()
    enum = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert pfd.VARIANTS == rpf.VARIANTS
    assert codes == {"kSimt": pfd.VARIANTS.index("simt"),
                     "kMma": pfd.VARIANTS.index("mma")}


@pytest.mark.parametrize("base,S,keys,splits", [
    (128, 2048, 128, 16),   # qwen2-1.5b serving: cache_len 2048
    (128, 0, 128, 1),
    (128, 32, 128, 1),
    (128, 128, 128, 1),
    (128, 129, 128, 2),
    (128, 4096, 128, 32),
    (128, 8192, 256, 32),   # long rows: wider splits, never more than 32
    (128, 32768, 1024, 32),
    (64, 2048, 64, 32),
    (64, 100, 64, 2),
    (256, 2048, 256, 8),
    (256, 5000, 256, 20),
])
def test_split_geometry(monkeypatch, base, S, keys, splits):
    monkeypatch.setattr(pfd, "SPLIT_KEYS", base)
    assert pfd.split_keys(S) == keys and keys % 64 == 0
    assert pfd.n_splits(S) == splits
    assert pfd.n_splits(S) * keys >= S


@pytest.mark.parametrize("hd,page,pps,fits", [
    (128, 16, 128, True),   # qwen2-1.5b serving
    (256, 16, 128, True),   # the largest head_dim
    (80, 8, 64, True),
    (264, 16, 128, False),  # head_dim above 256
    (128, 1, 20000, False),  # a split would span 641 block-table entries
])
def test_check_kernel_fits(hd, page, pps, fits):
    q = torch.zeros(2, 2, 6, hd)
    kp = vp = torch.zeros(4, page, 2, hd)
    ptab = torch.zeros(2, pps, dtype=torch.int32)
    if fits:
        pfd.check_kernel_fits(q, kp, vp, ptab)
    else:
        with pytest.raises(ValueError):
            pfd.check_kernel_fits(q, kp, vp, ptab)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
def test_mma_shared_memory_leaves_two_blocks_an_sm(hd, kv_dtype):
    """The mma variant's layout (``_smem_bytes``, mirroring ``MmaSmem``):
    q rows, a two-stage ring of 64-key K/V tiles padded by 16 bytes a row,
    for int8 scale rows and each warp's widened keys; two blocks fit the
    SM's 228 KB."""
    row = 2 * hd + 16
    raw = hd + 16 if kv_dtype == torch.int8 else row
    got = pfd._smem_bytes("mma", kv_dtype, hd)
    assert got >= 16 * row + 2 * 2 * 64 * raw
    assert 2 * (got + 8 * 1024) <= 228 * 1024


def test_cpu_calls_count_no_variant():
    pfd.reset_launches()
    q, kp, vp, ptab, lens = _pack([5, 0, 17], G=6, hd=16, page=8, pps=4)
    for dtype in (torch.float32, torch.bfloat16):
        got = pfd.paged_flash_decode(q.to(dtype), kp, vp, ptab, lens)
        assert got.dtype == dtype
    assert pfd.launches == 0 and set(pfd.launches_by_variant.values()) == {0}
    pfd.launches, pfd.launches_by_variant["mma"] = 3, 2
    pfd.reset_launches()
    assert pfd.launches == 0 and set(pfd.launches_by_variant.values()) == {0}


# ---------------------------------------------------------------------------
# on the card


def _pack(lens, *, G, hd, page, pps, kvH=2, seed=0):
    """One decode tick: slot b sees lens[b] entries; each slot maps only
    the pages its lens reach, the rest of its block-table row is the
    sentinel ``n_pages``.  float32 q and pools, int32 ptab and lens, on the
    CPU."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    n_pages = B * pps
    perm = rng.permutation(n_pages)
    ptab = np.full((B, pps), n_pages, np.int32)
    for b, n in enumerate(lens):
        used = -(-int(n) // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    normal = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    return (normal(B, kvH, G, hd), normal(n_pages, page, kvH, hd),
            normal(n_pages, page, kvH, hd), torch.from_numpy(ptab),
            torch.from_numpy(np.asarray(lens, np.int32)))


def _typed(pack, q_dtype, kv_dtype):
    """The pack on the card in the given types, int8 pools quantized:
    (q, kp, vp, ptab, lens, ks, vs)."""
    q, kp, vp, ptab, lens = (t.cuda() for t in pack)
    ks = vs = None
    if kv_dtype == "int8":
        kp, ks = tops.quantize_kv(kp)
        vp, vs = tops.quantize_kv(vp)
    kt = getattr(torch, kv_dtype)
    return q.to(getattr(torch, q_dtype)), kp.to(kt), vp.to(kt), ptab, lens, ks, vs


def _assert_close(got, want, q_dtype):
    if q_dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
        d = (got.float() - want.float()).norm(dim=-1)
        assert bool((d <= BF16_ROW_RTOL * want.float().norm(dim=-1)).all())


def _gpu_check(pack, q_dtype, kv_dtype):
    """Two launches on ``pack``: both through the variant
    ``kernel_variant`` names, equal to each other exactly and to the plain
    version within the tolerance; ``lens == 0`` slots exactly zero."""
    q, kp, vp, ptab, lens, ks, vs = _typed(pack, q_dtype, kv_dtype)
    pfd.reset_launches()
    got = pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)
    again = pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)
    torch.cuda.synchronize()
    variant = pfd.kernel_variant(q, kp, vp)
    assert pfd.launches == pfd.launches_by_variant[variant] == 2
    assert torch.equal(got, again)
    want = pfd.paged_flash_decode_ref(q, kp, vp, ptab, lens, ks=ks, vs=vs)
    _assert_close(got, want, q_dtype)
    assert bool((got[lens == 0] == 0).all())


_DTYPE_PAIRS = [(q, kv) for q in ("float32", "bfloat16")
                for kv in ("float32", "bfloat16", "int8")]


def _split_lens(S):
    """Lens on every split path of a row of S keys."""
    ks = pfd.split_keys(S)
    return [1, ks - 1, ks, ks + 1, 2 * ks + 5, S, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", _DTYPE_PAIRS)
@pytest.mark.parametrize("G", [6, 20])
def test_cuda_kernel_on_every_split_path(G, q_dtype, kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _gpu_check(_pack(_split_lens(1024), G=G, hd=128, page=16, pps=64),
               q_dtype, kv_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", _DTYPE_PAIRS)
@pytest.mark.parametrize("G,hd,page", [(g, h, p) for g in (1, 4, 6, 8)
                                       for h in (64, 128, 80)
                                       for p in (8, 16, 32)])
def test_cuda_kernel_on_shapes(G, hd, page, q_dtype, kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _gpu_check(_pack(_split_lens(512), G=G, hd=hd, page=page, pps=512 // page,
                     seed=G + hd + page), q_dtype, kv_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cuda_kernel_makes_no_host_synchronisation(kv_dtype):
    """The wrapper's grid, scratch and split counters follow from shapes:
    no ``.item()``, ``.cpu()`` or ``.tolist()`` of a device tensor.  Under
    sync debug mode "error" any such call raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, kp, vp, ptab, lens, ks, vs = _typed(
        _pack(_split_lens(2048), G=6, hd=128, page=16, pps=128), "bfloat16",
        kv_dtype)
    pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = pfd.paged_flash_decode_ref(q, kp, vp, ptab, lens, ks=ks, vs=vs)
    _assert_close(got, want, "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", _DTYPE_PAIRS)
def test_cuda_kernel_matches_ragged_kernel_with_one_token_per_slot(q_dtype,
                                                                   kv_dtype):
    """A decode tick is a ragged pack of one token per slot: the two CUDA
    kernels agree on it within the tolerance each holds to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, kp, vp, ptab, lens, ks, vs = _typed(
        _pack([2048, 1500, 1101, 701, 421, 201, 65, 0], G=6, hd=128, page=16,
              pps=128), q_dtype, kv_dtype)
    slot = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    got = pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)
    other = rpf.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    torch.cuda.synchronize()
    _assert_close(got, other, q_dtype)


def test_trace_points_are_found_in_the_kernel_source():
    """``benchmarks/decode_trace.py`` instruments a copy of the kernel at
    fixed places; each must still be there, once per kernel that has it."""
    from repro_torch.benchmarks import decode_trace

    src = decode_trace.traced_source()
    assert src.count("STAMP(") == 1 + 2 * 2 + 5  # the macro, entry/begin x2, the rest
    for k in range(7):
        assert f"STAMP({k});" in src
