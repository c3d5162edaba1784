"""The serving sweep's latency and prefix-cache scenarios: the port's
(``repro_torch.benchmarks.serve_sweep``) against the JAX package's root
``benchmarks/serve_sweep.py`` on the CPU, at the qwen2-1.5b smoke config in
float32 with the same weights.  Every field that is not a time is equal:
ticks (the two-phase engine stalls decoders behind prefill), prefix hits,
tokens reused, COW copies, evictions, cached pages, traces and the
``token_identical`` flag (against the lock-step engine too)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import load_qwen, sweep_both  # noqa: E402


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_latency_scenario_matches_jax(qwen, warm):
    got, _ = sweep_both("latency_scenario", qwen, cache_len=256, warm=warm)
    # every chat token after the first waits out prefill on the two-phase
    # engine only: it takes more ticks for the same tokens
    assert got["chunked"]["ticks"] > got["ragged"]["ticks"] > 0


def test_prefix_scenario_matches_jax(qwen):
    got, _ = sweep_both("prefix_scenario", qwen, cache_len=256)
    assert got["token_identical"]
    on, off = got["prefix-on"], got["prefix-off"]
    assert on["prefix_hit_rate"] == 1.0 and on["tokens_reused"] > 0
    assert off["prefix_hit_rate"] == 0.0 and off["cached_pages"] == 0
    assert on["traces"] == off["traces"] == 1
