"""The port's RMSNorm kernel module and the norm layer's kernel route
against the JAX package.

- ``rmsnorm_ref`` (the plain version of the CUDA kernel) and the wrapper on
  CPU tensors against the Pallas kernel ``repro.kernels.ops.rmsnorm`` in
  interpret mode, on the cases of tests/test_kernels.py (row counts that
  do not fill a row block, float32 and bfloat16); tolerance as there, 2e-4
  (float32) and 2e-2 (bfloat16).  Scale invariance as a property.
- ``models.layers.norms.rmsnorm(use_kernel=True)`` equals the plain path on
  the CPU, and equals JAX's kernel route.
- ``rmsnorm_plan`` (route and threads per row), the C entry's route
  codes, the per-route counts staying 0 on the CPU, and the wrapper on a
  misaligned contiguous slice.
- ``gpu`` tests holding the CUDA kernel against the plain version (every
  route, odd and wide rows, a single row, a misaligned slice); they skip
  where there is no card.

JAX is imported by a fixture, not at module level, so that the ``gpu``
test also runs where only PyTorch is installed.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models.layers import norms  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    from repro.models.layers import norms as jnorms

    return types.SimpleNamespace(jnp=jnp, ops=ops, norms=jnorms)


def _inputs(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    s = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32))
    return x, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 37, 96), (1, 128), (3, 5, 7, 64)])
def test_plain_version_matches_pallas_kernel(jx, shape, dtype):
    x, s = _inputs(shape, dtype)
    jnp = jx.jnp
    j = jx.ops.rmsnorm(jnp.asarray(x.float().numpy(), getattr(jnp, dtype)),
                       jnp.asarray(s.numpy()))
    t = tops.rmsnorm(x, s)
    assert t.dtype == x.dtype and t.shape == x.shape
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=2e-4, atol=2e-4))
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               **tol)
    torch.testing.assert_close(t, rn.rmsnorm_ref(x, s), rtol=0, atol=0)


@settings(max_examples=10, deadline=None)
@given(scale=st.floats(0.1, 100.0), rows=st.integers(1, 8))
def test_scale_invariance(scale, rows):
    """Property: rmsnorm(ax) == rmsnorm(x) for a > 0."""
    x = torch.randn(rows, 64, generator=torch.Generator().manual_seed(rows))
    s = torch.ones(64)
    torch.testing.assert_close(tops.rmsnorm(x * scale, s), tops.rmsnorm(x, s),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_layer_kernel_route_equals_plain_path(jx, dtype):
    x, s = _inputs((2, 9, 64), dtype, seed=1)
    params = {"scale": s}
    got = norms.rmsnorm(params, x, 1e-6, use_kernel=True)
    want = norms.rmsnorm(params, x, 1e-6)
    assert got.dtype == want.dtype == x.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jnp = jx.jnp
    j = jx.norms.rmsnorm({"scale": jnp.asarray(s.numpy())},
                         jnp.asarray(x.float().numpy(), getattr(jnp, dtype)),
                         1e-6, use_kernel=True)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=2e-5, atol=2e-5))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(j.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("bad", ["scale_shape", "x_dtype", "scale_dtype",
                                 "noncontiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    x, s = torch.randn(4, 16), torch.ones(16)
    if bad == "scale_shape":
        s = torch.ones(8)
    elif bad == "x_dtype":
        x = x.half()
    elif bad == "scale_dtype":
        s = s.bfloat16()
    else:
        x = torch.randn(16, 4).t()
    with pytest.raises((TypeError, ValueError)):
        tops.rmsnorm(x, s)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    x, s = _inputs((5, 32), "float32")
    before = rn.launches
    torch.testing.assert_close(tops.rmsnorm(x, s), rn.rmsnorm_ref(x, s),
                               rtol=0, atol=0)
    assert rn.launches == before


@pytest.mark.parametrize("R,D,itemsize,aligned,want", [
    (8192, 1536, 2, True, ("cached", 32)),   # training activations: a warp a row
    (256, 1536, 2, True, ("cached", 256)),   # serving pack: a block a row
    (8192, 1536, 4, True, ("cached", 64)),   # 384 vectors: 6 a thread
    (256, 1536, 4, True, ("cached", 256)),
    (1, 1536, 2, True, ("cached", 256)),
    (2, 8192, 2, True, ("cached", 256)),
    (4, 96, 4, True, ("cached", 32)),        # 24 vectors: one warp is enough
    (4, 32768, 4, True, ("reread", 256)),    # 8192 vectors: past the cache
    (5, 333, 4, True, ("scalar", 32)),       # rows not a multiple of 16 bytes
    (5, 1001, 2, True, ("scalar", 32)),
    (4, 1536, 4, False, ("scalar", 32)),     # a pointer off alignment
])
def test_rmsnorm_plan(R, D, itemsize, aligned, want):
    assert rn.rmsnorm_plan(R, D, itemsize, aligned) == want


def test_route_codes_match_the_cuda_source():
    """The wrapper passes ``ROUTES.index(route)``; the C entry reads it as
    its ``Route`` enum."""
    import re

    src = (build.CSRC / "rmsnorm.cu").read_text()
    enum = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kScalar": rn.ROUTES.index("scalar"),
                     "kCached": rn.ROUTES.index("cached"),
                     "kReread": rn.ROUTES.index("reread")}


def _misaligned(R, D, dtype, seed=3):
    """A contiguous (R, D) view that starts one element into its storage:
    not 16-byte aligned."""
    rng = np.random.RandomState(seed)
    base = torch.from_numpy(rng.standard_normal(1 + R * D).astype(np.float32))
    x = base.to(getattr(torch, dtype))[1:].view(R, D)
    s = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    return x, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_on_misaligned_contiguous_slice(dtype):
    """A 1-D slice is contiguous yet off 16-byte alignment: the wrapper
    takes it (the plain version on the CPU), and the plan sends such rows
    to the scalar route."""
    x, s = _misaligned(4, 64, dtype)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    rn.reset_launches()
    torch.testing.assert_close(tops.rmsnorm(x, s), rn.rmsnorm_ref(x, s),
                               rtol=0, atol=0)
    assert rn.launches == 0 and set(rn.launches_by_route.values()) == {0}
    assert rn.rmsnorm_plan(4, 64, x.element_size(), False)[0] == "scalar"


def test_cpu_calls_count_no_route():
    rn.reset_launches()
    for dtype in ("float32", "bfloat16"):
        tops.rmsnorm(*_inputs((3, 64), dtype))
    assert rn.launches == 0 and set(rn.launches_by_route.values()) == {0}
    rn.launches, rn.launches_by_route["cached"] = 3, 2
    rn.reset_launches()
    assert rn.launches == 0 and set(rn.launches_by_route.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 37, 96), (256, 1536), (3, 1000)])
def test_cuda_kernel_matches_plain_version(shape, dtype):
    """The hand-written CUDA kernel against ``rmsnorm_ref`` on the card.
    Tolerance: float32 rtol = atol = 1e-5 (rsqrtf against torch.rsqrt, and
    another summation order); bfloat16 outputs one rounding unit (rtol
    2^-7), compared in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, s = (t.cuda() for t in _inputs(shape, dtype, seed=2))
    before = rn.launches
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn.launches == before + 1
    want = rn.rmsnorm_ref(x, s)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 333), (2, 8192), (1, 1536), (8192, 1536),
                                   (4, 32768), "misaligned"])
def test_cuda_routes_match_plain_version(shape, dtype):
    """Each route on the card: odd rows (scalar), wide rows and single rows
    (cached, a block a row), the training activations (cached, a warp a
    row), rows past the register cache (reread) and a misaligned slice
    (scalar), each launch through the route ``rmsnorm_plan`` names.
    Tolerance as test_cuda_kernel_matches_plain_version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shape == "misaligned":  # one element of padding, sliced on the card
        x, s = _misaligned(6, 1536, dtype)
        x = torch.cat([x.new_zeros(1), x.reshape(-1)]).cuda()[1:].view(6, 1536)
        s = s.cuda()
    else:
        x, s = (t.cuda() for t in _inputs(shape, dtype, seed=4))
    R, D = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, s))
    route = rn.rmsnorm_plan(R, D, x.element_size(), aligned)[0]
    rn.reset_launches()
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn.launches == rn.launches_by_route[route] == 1
    assert (route == "scalar") == (shape in ((5, 333), "misaligned"))
    want = rn.rmsnorm_ref(x, s)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)
