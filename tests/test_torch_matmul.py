"""The port's matmul kernel module, the measured sweep and the memory modes
against the JAX package.

- ``matmul_ref`` (the plain version of the CUDA kernel) and the wrapper on
  CPU tensors against the Pallas kernel ``repro.kernels.ops.matmul`` in
  interpret mode, on the cases of tests/test_kernels.py: shapes that need
  padding, float32 and bfloat16, both ``accum`` policies, block invariance
  and linearity.  Tolerance as there: 2e-4 (float32), 2e-2 (bfloat16).
- ``k_slices``: the ``hbm`` policy's passes over C are the TPU kernel's
  ``Kp // bk`` K steps.
- ``matmul_route``, the wrapper's choice of load route per launch from the
  dtype, the row strides, the slice start and the pointers' alignment, for
  each branch; its order of routes against the C source's enum.
- ``core.sweep`` and ``core.memory_modes``: ``SweepCell.n``,
  ``factorizations``, ``tiling_grid``, ``MODES``/``apply`` equal JAX's;
  ``measured_gflops(..., device="cpu")`` sizes every point as JAX does and
  both engines compute ``matmul_ref``'s product.
- ``repro_torch.benchmarks.run --device cpu --small`` prints the CSV.
- ``gpu`` tests holding the CUDA kernel's four routes against the plain
  version, with the per-route launch counts; they skip where there is no
  card.

JAX is imported by a fixture, not at module level, so that the ``gpu``
tests also run where only PyTorch is installed.
"""
import math
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import memory_modes as tmm  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [(64, 64, 64), (128, 96, 32), (100, 130, 70), (256, 512, 128),
          (32, 1024, 32)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.core import memory_modes, sweep
    from repro.kernels import ops

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ops=ops, sweep=sweep,
                                 memory_modes=memory_modes)


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def _operands(M, K, N, dtype, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    # the JAX side gets the same (bf16-rounded) values
    return ta, tb, ta.float().numpy(), tb.float().numpy()


@pytest.mark.parametrize("accum", ["vmem", "hbm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_kernel(jx, shape, dtype, accum):
    M, K, N = shape
    ta, tb, a, b = _operands(M, K, N, dtype)
    jdt = getattr(jx.jnp, dtype)
    j = jx.ops.matmul(jx.jnp.asarray(a, jdt), jx.jnp.asarray(b, jdt),
                      block=(32, 64, 32), accum=accum)
    t = tops.matmul(ta, tb, block=(32, 64, 32), accum=accum)
    assert t.dtype == ta.dtype and t.shape == (M, N)
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jx.jnp.float32)), **_tol(dtype))
    torch.testing.assert_close(t, mm.matmul_ref(ta, tb), rtol=0, atol=0)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_out_dtype_matches_pallas_kernel(jx, out_dtype):
    ta, tb, a, b = _operands(100, 130, 70, "bfloat16", seed=2)
    odt = getattr(torch, out_dtype)
    j = jx.ops.matmul(jx.jnp.asarray(a, jx.jnp.bfloat16),
                      jx.jnp.asarray(b, jx.jnp.bfloat16), accum="hbm",
                      out_dtype=getattr(jx.jnp, out_dtype))
    t = mm.matmul_ref(ta, tb, odt)
    assert t.dtype == odt
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jx.jnp.float32)),
                               **_tol(out_dtype))


@pytest.mark.parametrize("block", [(16, 16, 16), (32, 64, 32), (128, 128, 128)])
def test_block_invariance(jx, block):
    ta, tb, a, b = _operands(96, 160, 64, "float32", seed=1)
    j = jx.ops.matmul(jx.jnp.asarray(a), jx.jnp.asarray(b), block=block)
    for accum in mm.ACCUMS:
        t = tops.matmul(ta, tb, block=block, accum=accum)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(m=st.integers(8, 64), k=st.integers(8, 96), n=st.integers(8, 48))
def test_linearity(m, k, n):
    """Property: matmul(a, b1 + b2) == matmul(a, b1) + matmul(a, b2)."""
    g = torch.Generator().manual_seed(m * 10000 + k * 100 + n)
    a, b1, b2 = (torch.randn(s, generator=g) for s in ((m, k), (k, n), (k, n)))
    lhs = tops.matmul(a, b1 + b2, block=(16, 16, 16))
    rhs = (tops.matmul(a, b1, block=(16, 16, 16))
           + tops.matmul(a, b2, block=(16, 16, 16), accum="hbm"))
    torch.testing.assert_close(lhs, rhs, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("K,bk", [(1024, 64), (130, 64), (96, 256), (8192, 2048),
                                  (1500, 256)])
def test_hbm_passes_are_the_tpu_kernels_k_steps(K, bk):
    """The TPU kernel caps bk at K and zero-pads K to Kp: its grid has
    Kp // bk K steps, each revisiting C.  ``k_slices`` tiles [0, K) in the
    same number of slices, the last one ragged where Kp pads."""
    bk_eff = min(bk, K)
    Kp = K + (-K) % bk_eff
    slices = mm.k_slices(K, (32, bk, 32), "hbm")
    assert len(slices) == Kp // bk_eff == mm.k_passes(K, (32, bk, 32), "hbm")
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(s1 == e0 for (_, e0), (s1, _) in zip(slices, slices[1:]))
    assert mm.k_slices(K, (32, bk, 32), "vmem") == [(0, K)]


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, torch.float32)])
def test_policy_bytes_counts_the_c_passes(dtype, out_dtype):
    """``vmem`` moves A, B and C once; ``hbm`` adds a float32 C read and
    written per K pass, and a cast (one more float32 read, the output
    written) only where the output is not float32."""
    M, K, N, block = 300, 1024, 200, (32, 256, 32)
    item = torch.empty((), dtype=dtype).element_size()
    out_item = torch.empty((), dtype=out_dtype or dtype).element_size()
    ab = (M * K + K * N) * item
    assert mm.policy_bytes(M, K, N, dtype, block, "vmem",
                           out_dtype) == ab + M * N * out_item
    cast = 0 if (out_dtype or dtype) == torch.float32 else M * N * (4 + out_item)
    assert mm.policy_bytes(M, K, N, dtype, block, "hbm", out_dtype) == (
        ab + 2 * 4 * M * N * 4 + cast)


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "accum", "block",
                                 "out_dtype", "noncontiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    kw = {}
    if bad == "shape":
        b = torch.ones(8, 4)
    elif bad == "dtype":
        a, b = a.half(), b.half()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "accum":
        kw = dict(accum="smem")
    elif bad == "block":
        kw = dict(block=(16, 0, 16))
    elif bad == "out_dtype":
        kw = dict(out_dtype=torch.float16)
    else:
        a = torch.ones(16, 8).t()
    with pytest.raises((TypeError, ValueError)):
        tops.matmul(a, b, **kw)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    a, b = torch.randn(40, 24), torch.randn(24, 16)
    before = mm.launches
    for accum in mm.ACCUMS:
        torch.testing.assert_close(tops.matmul(a, b, accum=accum),
                                   mm.matmul_ref(a, b), rtol=0, atol=0)
    assert mm.launches == before


# ---------------------------------------------------------------------------
# the route choice (pure Python)


@pytest.mark.parametrize("dtype,K,N,k0,aligned,want", [
    (torch.float32, 4096, 4096, 0, True, "fma_async"),    # the sweep
    (torch.float32, 1500, 700, 256, True, "fma_async"),
    (torch.float32, 130, 70, 0, True, "fma_scalar"),      # 520 and 280 B rows
    (torch.float32, 1024, 30, 0, True, "fma_scalar"),     # N row not 16-byte
    (torch.float32, 30, 1024, 0, True, "fma_scalar"),     # K row not 16-byte
    (torch.float32, 512, 128, 30, True, "fma_scalar"),    # slice start at 120 B
    (torch.float32, 512, 128, 40, True, "fma_async"),     # ... at 160 B
    (torch.float32, 4096, 4096, 0, False, "fma_scalar"),  # a pointer off 16 B
    (torch.bfloat16, 4096, 4096, 0, True, "wgmma_tma"),
    (torch.bfloat16, 512, 128, 0, True, "wgmma_tma"),
    (torch.bfloat16, 512, 128, 40, True, "wgmma_tma"),    # box start at 80 B
    (torch.bfloat16, 512, 128, 30, True, "wgmma_staged"),  # ... at 60 B
    (torch.bfloat16, 130, 70, 0, True, "wgmma_staged"),   # 260 B rows
    (torch.bfloat16, 1500, 700, 0, True, "wgmma_staged"),  # 3000 B rows
    (torch.bfloat16, 1504, 700, 0, True, "wgmma_staged"),  # 1400 B rows of B
    (torch.bfloat16, 1504, 704, 0, True, "wgmma_tma"),
    (torch.bfloat16, 4096, 4096, 0, False, "wgmma_staged"),
])
def test_matmul_route_follows_dtype_and_layout(dtype, K, N, k0, aligned, want):
    assert mm.matmul_route(dtype, K, N, k0, aligned) == want


def test_route_codes_match_the_cuda_source():
    """The wrapper passes ``ROUTES.index(route)``; the C entry reads it as
    its ``Route`` enum."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "matmul.cu").read_text()
    enum = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kFmaAsync": mm.ROUTES.index("fma_async"),
                     "kFmaScalar": mm.ROUTES.index("fma_scalar"),
                     "kWgmmaTma": mm.ROUTES.index("wgmma_tma"),
                     "kWgmmaStaged": mm.ROUTES.index("wgmma_staged")}


def test_cpu_calls_count_no_route():
    mm.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        a, b = torch.randn(40, 24).to(dtype), torch.randn(24, 16).to(dtype)
        for accum in mm.ACCUMS:
            tops.matmul(a, b, accum=accum, block=(8, 8, 8))
    assert mm.launches == 0 and set(mm.launches_by_route.values()) == {0}
    mm.launches, mm.launches_by_route["wgmma_tma"] = 5, 5
    mm.reset_launches()
    assert mm.launches == 0 and set(mm.launches_by_route.values()) == {0}


# ---------------------------------------------------------------------------
# core.sweep and core.memory_modes


def test_sweep_cells_and_factorizations_equal_jax(jx):
    for n_units in (1, 2, 8, 64, 256):
        assert tsweep.factorizations(n_units) == jx.sweep.factorizations(n_units)
    for n0 in (512, 2048, 16384, 98304):
        for nproc in (1, 2, 3, 4, 8, 16, 32, 64, 256):
            kw = dict(nproc=nproc, nthread=1, n0=n0)
            assert tsweep.SweepCell(**kw).n == jx.sweep.SweepCell(**kw).n
    assert tsweep.PLACEMENTS == jx.sweep.PLACEMENTS
    assert tsweep.MEMORIES == jx.sweep.MEMORIES


def test_memory_modes_equal_jax(jx):
    jm = jx.memory_modes
    key = lambda m: (m.name, m.remat, m.block, m.k_splits, m.moe_impl,  # noqa: E731
                     m.vmem_bytes())
    assert [key(m) for m in tmm.tiling_grid()] == [key(m) for m in jm.tiling_grid()]
    assert len(tmm.tiling_grid()) == 15
    assert ([key(m) for m in tmm.tiling_grid(8 * 2**20)]
            == [key(m) for m in jm.tiling_grid(8 * 2**20)])
    assert {k: key(m) for k, m in tmm.MODES.items()} == {
        k: key(m) for k, m in jm.MODES.items()}
    cfg = tget("qwen2-1.5b", smoke=True)
    for name, mode in tmm.MODES.items():
        assert tmm.apply(cfg, mode).remat == jm.MODES[name].remat


def test_measured_gflops_sizes_every_point_as_jax(jx):
    n0 = 256
    for nproc in (1, 2, 4, 8):
        j = jx.sweep.measured_gflops("xla", nproc, n0=n0, reps=1)
        for engine in tsweep.ENGINES:
            t = tsweep.measured_gflops(engine, nproc, n0=n0, reps=1,
                                       device="cpu")
            assert t["N"] == j["N"] == tsweep.sweep_n(n0, nproc)
            assert t["engine"] == engine and t["nproc"] == nproc
            assert t["device"] == "cpu" and t["gflops"] > 0
            assert math.isclose(t["gflops"] * t["us_per_call"] * 1e3,
                                2.0 * nproc * t["N"] ** 3, rel_tol=1e-9)
    with pytest.raises(ValueError, match="engine"):
        tsweep.measured_gflops("xla", 1, n0=n0, device="cpu")


@pytest.mark.parametrize("engine", sorted(tsweep.ENGINES))
def test_sweep_engines_compute_the_product(engine):
    a, b = tsweep.sweep_operands(3, 256, device="cpu")
    assert a.shape == b.shape == (3, 128, 128)  # 256 / sqrt(3) rounds to 128
    got = tsweep.ENGINES[engine](a, b)
    for i in range(3):
        torch.testing.assert_close(got[i], mm.matmul_ref(a[i], b[i]),
                                   rtol=1e-5, atol=1e-4)


def test_benchmarks_print_the_csv_on_cpu(capsys):
    assert bench_run.main(["--device", "cpu", "--small"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [ln.split(",")[0] for ln in lines[1:]]
    assert [n for n in names if n.startswith("fig4/")] == [
        "fig4/cublas/measured/nproc=1/N=256", "fig4/cublas/measured/nproc=2/N=192",
        "fig4/cublas/measured/nproc=4/N=128"]
    assert len([n for n in names if n.startswith("fig5/kernel/")]) == 3
    assert len([n for n in names if n.startswith("memmode/")]) == 15
    assert all(len(ln.split(",")) == 3 for ln in lines)


def test_benchmarks_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_run.main(["--small"])


# ---------------------------------------------------------------------------
# the CUDA kernel on the card


@pytest.mark.gpu
@pytest.mark.parametrize("accum", ["vmem", "hbm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(100, 130, 70), (256, 512, 128), (1000, 1500, 700)])
def test_cuda_kernel_matches_plain_version(shape, dtype, accum):
    """The hand-written CUDA kernel against ``matmul_ref`` on the card.
    Tolerance: float32 rtol 1e-4; bfloat16 outputs one bf16 rounding unit
    (rtol 2^-7: both sides round one float32 sum) — each with an atol that
    scales with sqrt(K) |a| |b|, the size of the sum's terms' spread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, K, N = shape
    ta, tb, _, _ = _operands(M, K, N, dtype, seed=3)
    ta, tb = ta.cuda(), tb.cuda()
    before = mm.launches
    route = mm.matmul_route(ta.dtype, K, N)
    by_route = dict(mm.launches_by_route)
    got = mm.matmul(ta, tb, block=(32, 64, 32), accum=accum)
    torch.cuda.synchronize()
    passes = mm.k_passes(K, (32, 64, 32), accum)
    assert mm.launches == before + passes
    assert mm.launches_by_route == {**by_route, route: by_route[route] + passes}
    want = mm.matmul_ref(ta, tb)
    spread = math.sqrt(K) * float(ta.float().std()) * float(tb.float().std())
    tol = (dict(rtol=1e-4, atol=2 ** -16 * spread) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=2 ** -12 * spread))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_cuda_kernel_out_dtype():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = torch.randn(64, 96, device="cuda"), torch.randn(96, 80, device="cuda")
    for accum in mm.ACCUMS:
        got = mm.matmul(a, b, accum=accum, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, mm.matmul_ref(a, b, torch.bfloat16),
                                   rtol=2 ** -7, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(256, 256, 256), (32, 40, 32)])
@pytest.mark.parametrize("accum", ["vmem", "hbm"])
@pytest.mark.parametrize("shape,route", [
    ((256, 512, 128), "wgmma_tma"), ((4096, 4096, 4096), "wgmma_tma"),
    ((100, 130, 70), "wgmma_staged"), ((1000, 1500, 700), "wgmma_staged")])
def test_cuda_bf16_routes_match_plain_version(shape, route, accum, block):
    """bf16 through both wgmma load routes, both policies; block (32, 40, 32)
    gives ``hbm`` slices 40 deep, not a multiple of the 64-deep k-tile, each
    masked at its own end.  Tolerance as above: one bf16 rounding unit
    (rtol 2^-7) with atol 2^-12 x sqrt(K) |a| |b|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, K, N = shape
    ta, tb, _, _ = _operands(M, K, N, "bfloat16", seed=4)
    ta, tb = ta.cuda(), tb.cuda()
    mm.reset_launches()
    got = mm.matmul(ta, tb, block=block, accum=accum)
    torch.cuda.synchronize()
    assert mm.launches_by_route[route] == mm.launches == mm.k_passes(K, block, accum)
    want = mm.matmul_ref(ta, tb)
    spread = math.sqrt(K) * float(ta.float().std()) * float(tb.float().std())
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -12 * spread)


@pytest.mark.gpu
@pytest.mark.parametrize("accum", ["vmem", "hbm"])
@pytest.mark.parametrize("shape", [(256, 512, 128), (100, 130, 70)])
def test_cuda_bf16_inputs_float32_output(shape, accum):
    """bf16 inputs, float32 output: the float32 sum is kept, not rounded to
    bf16 — rtol 1e-4 with atol 2^-16 x sqrt(K) |a| |b|, the float32
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M, K, N = shape
    ta, tb, _, _ = _operands(M, K, N, "bfloat16", seed=6)
    ta, tb = ta.cuda(), tb.cuda()
    got = mm.matmul(ta, tb, accum=accum, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = mm.matmul_ref(ta, tb, torch.float32)
    spread = math.sqrt(K) * float(ta.float().std()) * float(tb.float().std())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2 ** -16 * spread)
