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
- A ``gpu`` test holding the CUDA kernel against the plain version; it
  skips where there is no card.

JAX is imported by the ``jax_ops`` fixture, not at module level, so that the
``gpu`` tests also run where only PyTorch is installed.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

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
