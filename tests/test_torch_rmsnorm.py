"""The port's RMSNorm kernel module and the norm layer's kernel route
against the JAX package.

- ``rmsnorm_ref`` (the plain version of the CUDA kernel) and the wrapper on
  CPU tensors against the Pallas kernel ``repro.kernels.ops.rmsnorm`` in
  interpret mode, on the cases of tests/test_kernels.py (row counts that
  do not fill a row block, float32 and bfloat16); tolerance as there, 2e-4
  (float32) and 2e-2 (bfloat16).  Scale invariance as a property.
- ``models.layers.norms.rmsnorm(use_kernel=True)`` equals the plain path on
  the CPU, and equals JAX's kernel route.
- A ``gpu`` test holding the CUDA kernel against the plain version; it
  skips where there is no card.

JAX is imported by a fixture, not at module level, so that the ``gpu``
test also runs where only PyTorch is installed.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

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
