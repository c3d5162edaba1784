"""Error-feedback int8 compressed DDP in the port against the JAX package,
on 4 gloo ranks on the CPU:

- the port's quantizer (the optimizer state's ``quantize`` /
  ``dequantize``) bit-equal to JAX's ``_quant`` / ``_dequant`` on random
  rows and a zero row;
- the mirror of tests/test_multidevice.py::test_compressed_ddp_converges:
  ``make_ddp_value_and_grad`` brings the regression problem (64 x 16,
  numpy seed 0) to a loss under 1e-8 in 250 steps of w -= 0.1 g on every
  rank;
- in its first three steps, the compressed mean and each rank's new
  error-feedback residual equal JAX's ``ef_compressed_mean`` run under
  ``jax.vmap(..., axis_name="data")`` (no fake devices) over the same
  inputs — the four ranks' own gradients and residuals of that step —
  within 1e-6; each residual is the one the rank kept from the step
  before (zeros at first).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.optim.quantized_state import dequantize, quantize  # noqa: E402

STEPS, RECORD, TOL = 250, 3, 1e-6


def test_quant_is_bit_equal_to_jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.optim import compress as JC

    x = np.random.RandomState(3).standard_normal((6, 40)).astype(np.float32)
    x[2] = 0.0
    qx = quantize(torch.from_numpy(x))
    jq, js = JC._quant(jnp.asarray(x))
    np.testing.assert_array_equal(qx["q"].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(qx["qscale"].numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize(qx).numpy(),
                                  np.asarray(JC._dequant(jq, js)))


def regression():
    rng = np.random.RandomState(0)
    X = rng.standard_normal((64, 16)).astype(np.float32)
    y = X @ rng.standard_normal(16).astype(np.float32)
    return X, y


def jax_means(seen):
    """JAX's ``ef_compressed_mean`` under ``jax.vmap(..., axis_name="data")``
    over the 4 ranks' recorded gradients and residuals of one step:
    (means (4, 16), residuals (4, 16))."""
    import jax
    import jax.numpy as jnp

    from repro.optim.compress import EFState, ef_compressed_mean

    g = jnp.stack([jnp.asarray(s[0]) for s in seen])
    res = jnp.stack([jnp.asarray(s[1]) for s in seen])
    mean, ef = jax.vmap(lambda x, r: ef_compressed_mean(x, EFState(r), "data"),
                        axis_name="data")(g, res)
    return np.asarray(mean), np.asarray(ef.residual)


def test_compressed_ddp_converges_and_matches_jax():
    pytest.importorskip("jax")
    X, y = regression()
    results = run_ranks("_torch_train_ranks:ddp_rank", 4,
                        (X, y, STEPS, RECORD), device="cpu")
    for r, (loss, _) in enumerate(results):
        assert loss < 1e-8, (r, loss)
    for i in range(RECORD):
        step = [seen[i] for _, seen in results]
        mean, res = jax_means(step)
        for r, (_, before, got_mean, got_res) in enumerate(step):
            want_before = (np.zeros_like(before) if i == 0
                           else results[r][1][i - 1][3])
            np.testing.assert_array_equal(before, want_before)
            np.testing.assert_allclose(got_mean, mean[r], rtol=0, atol=TOL,
                                       err_msg=f"rank {r} step {i} mean")
            np.testing.assert_allclose(got_res, res[r], rtol=0, atol=TOL,
                                       err_msg=f"rank {r} step {i} residual")
