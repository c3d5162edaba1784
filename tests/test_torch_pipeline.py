"""GPipe pipeline parallelism in the port against the JAX package, on gloo
ranks on the CPU (the mirror of tests/test_multidevice.py::
test_pipeline_parallel_matches_sequential): tanh(x @ w) stages, (P, 16,
16) weights and (5, 2, 16) microbatches from numpy seed 2, at P = 2, 4
and 8 ranks of a ('pipe',) mesh, each holding one stage:

- every rank's ``pipeline_apply`` output equals the sequential composition
  within rtol 1e-5 and atol 1e-6 (the JAX test's);
- each rank's gradient of sum(out ** 2) with respect to its stage equals
  ``jax.grad`` of the sequential composition's, at that stage, within
  1e-5: the ring shift's backward shifts the other way, and only the
  last stage's term of the final sum carries the output's gradient.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.launch.ranks import run_ranks  # noqa: E402


@pytest.mark.parametrize("stages", [2, 4, 8])
def test_pipeline_matches_sequential_and_its_gradient(stages):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    rng = np.random.RandomState(2)
    Ws = (rng.standard_normal((stages, 16, 16)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((5, 2, 16)).astype(np.float32)

    def seq(W):
        out = jnp.asarray(xs)
        for i in range(stages):
            out = jnp.tanh(out @ W[i])
        return out

    want = np.asarray(seq(jnp.asarray(Ws)))
    grads = np.asarray(jax.grad(lambda W: jnp.sum(seq(W) ** 2))(jnp.asarray(Ws)))
    for r, (out, g) in enumerate(run_ranks("_torch_train_ranks:pipeline_rank",
                                           stages, (Ws, xs), device="cpu")):
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {r} output")
        np.testing.assert_allclose(g, grads[r], rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r} gradient")
