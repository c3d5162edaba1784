"""Parity of the PyTorch port's layers with the JAX package's, on the CPU:
rmsnorm, RoPE at shared and per-row positions, embedding and the tied
head, and the dense FFN with each activation.  Inputs come from numpy
seeds; tolerance atol = rtol = 1e-5 (float32 both sides)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import MLPCfg  # noqa: E402
from repro.models.layers import embeddings as jemb  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.models.layers import norms as jnorms  # noqa: E402
from repro_torch.configs.base import MLPCfg as TMLPCfg  # noqa: E402
from repro_torch.models.layers import embeddings as temb  # noqa: E402
from repro_torch.models.layers import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import norms as tnorms  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(jax_out, torch_out):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.numpy(), **TOL)


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 16), (2, 4, 3, 32)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    _close(jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6),
           tnorms.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(theta, per_row):
    """Split-half rotation at shared (S,) or per-row (B, S) positions —
    the serving step rotates each pack token at its own position."""
    rng = np.random.RandomState(1)
    B, S, kvH, G, hd = 3, 7, 2, 2, 16
    x = rng.standard_normal((B, S, kvH, G, hd)).astype(np.float32)
    pos = (rng.randint(0, 128, (B, S)) if per_row
           else rng.randint(0, 128, S)).astype(np.int32)
    _close(jemb.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           temb.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta))


def test_embed_and_tied_logits_match_jax():
    rng = np.random.RandomState(2)
    V, D = 512, 64
    table = rng.standard_normal((V, D)).astype(np.float32)
    tokens = rng.randint(0, V, (2, 9)).astype(np.int32)
    j = jemb.embed_tokens({"tok_embed": jnp.asarray(table)},
                          jnp.asarray(tokens), jnp.float32)
    t = temb.embed_tokens({"tok_embed": torch.from_numpy(table)},
                          torch.from_numpy(tokens).long(), torch.float32)
    _close(j, t)
    h = rng.standard_normal((2, 9, D)).astype(np.float32)
    _close(jemb.logits_from_hidden({}, jnp.asarray(h),
                                   tied_embed=jnp.asarray(table)),
           temb.logits_from_hidden({}, torch.from_numpy(h),
                                   tied_embed=torch.from_numpy(table)))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu", False)])
def test_mlp_matches_jax(act, gated):
    """SwiGLU and the plain FFN; "gelu" is jax's tanh approximation on both
    sides (torch's default is the exact form)."""
    rng = np.random.RandomState(3)
    D, F = 32, 48
    p = {"w_up": rng.standard_normal((D, F)), "w_down": rng.standard_normal((F, D))}
    if gated:
        p["w_gate"] = rng.standard_normal((D, F))
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    j = jmlp.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                     MLPCfg(d_ff=F, gated=gated, act=act), jnp.asarray(x))
    t = tmlp.mlp_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                     TMLPCfg(d_ff=F, gated=gated, act=act), torch.from_numpy(x))
    _close(j, t)
