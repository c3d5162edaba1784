"""Tensor-parallel serving of the PyTorch port with the engine's other
features, on gloo rank processes, against the JAX package's 1-device
engine (the harness of tests/test_torch_tp_serve.py: the traffic of
tests/test_serve_tp.py, the same weights bridged through numpy, every
rank's transcript and stats held to JAX's run).

- qwen1.5-4b smoke, the two-phase engine (``ragged=False``: chunk steps
  then decode ticks), 2 ranks.
- qwen1.5-4b smoke, speculation (``spec_k=2``: the rollback step runs on
  each rank's state) with the host tier (``host_pages=8`` over a 10-page
  pool, and a second wave that demotes the family's pages and promotes
  them back: each rank's store holds its own heads and the movers move
  its slice), 2 ranks.
- gemma3-4b smoke (2 KV heads; sliding-window layers): the windowed
  layers' circular buffers split on heads too, 2 ranks.
- qwen2-1.5b smoke (2 KV heads) at 4 ranks: the head axis does not divide
  the heads, so every pool stays whole on every rank and nothing is
  gathered; ``kv_pool_bytes_per_device`` equals ``kv_pool_bytes``.

And the capture contract over a mesh engine: ``analysis.contracts
.engine_programs`` and ``prove_program`` over each rank's served engine
(ragged with speculation and the host tier, and two-phase) at 2 ranks find
nothing: no host synchronisation, pool pointers kept, writes landing in
the rank's pools, idle packs leaving the state bit-identical.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_tp_ranks as R  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine

    def case(arch, kw, tier_wave):
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        eng = ServeEngine(params, cfg, **{**R.TP_KW, **kw})
        return ((R.drive(eng, cfg.vocab_size, tier_wave), eng.stats),
                jax.tree.map(np.asarray, params))

    return types.SimpleNamespace(case=case)


CASES = [("qwen1.5-4b", {"ragged": False}, 4, 2),
         ("qwen1.5-4b", {"spec_k": 2, "host_pages": 8, "max_pages": 10}, 4, 2),
         ("gemma3-4b", {}, 2, 2),
         ("qwen2-1.5b", {}, 2, 4)]


@pytest.mark.parametrize("arch,kw,kv_heads,n", CASES,
                         ids=["two-phase", "spec-host", "gemma3-window",
                              "qwen2-whole-pools"])
def test_feature_matches_jax(jx, arch, kw, kv_heads, n):
    tier_wave = "host_pages" in kw
    ref, tree = jx.case(arch, kw, tier_wave)
    ranks = R.check_tp_case(ref, arch, tree, n, kw, kv_heads=kv_heads,
                            tier_wave=tier_wave)
    st = ranks[0][1]
    if tier_wave:  # drafts rolled back; pages demoted, then promoted
        assert st["spec_rollbacks"] > 0 and st["demotions"] > 0
        assert st["host_pages_promoted"] > 0
    if arch == "qwen2-1.5b":
        assert st["kv_pool_bytes_per_device"] == st["kv_pool_bytes"]


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_mesh_engine_programs_are_proved(ragged):
    from repro_torch.launch.ranks import run_ranks

    for progs in run_ranks("_torch_tp_ranks:contract_rank", 2,
                           ("qwen1.5-4b", 2, ragged), device="cpu"):
        assert [p[0] for p in progs] == (
            ["ragged_step", "rollback", "page_gather", "page_insert"]
            if ragged else
            ["chunk_step", "decode_step", "page_gather", "page_insert"])
        for name, findings, rec in progs:
            assert findings == [] and rec["proved"], (name, findings, rec)
