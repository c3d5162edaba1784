"""The serving sweep's scheduler A/B and tiered-KV scenarios: the port's
against the JAX package's root ``benchmarks/serve_sweep.py`` on the CPU, at
the qwen2-1.5b smoke config in float32 with the same weights.  Every field
that is not a time is equal: per policy the packed tokens, prefix tokens
reused, evictions, prefix hits, ticks and traces; per tier arm the
admission split (device / host / miss), pages promoted, demotions, host
evictions, evictions, ticks and traces; and the ``token_identical``
flags."""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import load_qwen, sweep_both  # noqa: E402


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


def test_scheduler_ab_scenario_matches_jax(qwen):
    got, _ = sweep_both("scheduler_ab_scenario", qwen, cache_len=256)
    assert got["token_identical"]
    # grouping a family keeps its prefix resident: fewer evictions
    assert got["prefix-aware"]["evictions"] < got["fifo"]["evictions"]
    assert all(got[s]["traces"] == 1 for s in ("fifo", "prefix-aware", "slo"))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_tiered_kv_scenario_matches_jax(qwen, warm):
    got, _ = sweep_both("tiered_kv_scenario", qwen, warm=warm)
    assert got["token_identical"]
    assert got["host_hit_rate"] == 1.0
    assert got["drop-on-evict"]["hit_split"]["miss"] == 3
    assert got["host-tier"]["pages_promoted"] > 0
