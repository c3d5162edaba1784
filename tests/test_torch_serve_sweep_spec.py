"""The serving sweep's speculative-decoding and fp32-vs-int8 pool
scenarios: the port's against the JAX package's root
``benchmarks/serve_sweep.py`` on the CPU, at the qwen2-1.5b smoke config in
float32 with the same weights.  Every field that is not a time is equal:
ticks, the draft ledger (drafted, accepted, rejected, rollbacks), accepted
tokens per slot-tick, the page-leak gate after a cancel-mid-draft wave, the
pool byte budget and pages of each arm, resident pages, peak pages in use,
bytes per token, top-1 agreement and the int8 warm-prefix replay."""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import load_qwen, sweep_both  # noqa: E402


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


def test_speculative_scenario_matches_jax(qwen):
    got, _ = sweep_both("speculative_scenario", qwen, warm=False)
    assert got["token_identical"] and got["page_leak_free"]
    on = got["spec-on"]
    assert on["accepted"] > 0 and on["drafted"] == on["accepted"] + on["rejected"]
    assert got["accepted_per_tick"] > 1.0


def test_kv_ab_scenario_matches_jax(qwen):
    got, _ = sweep_both("kv_ab_scenario", qwen, warm=False)
    assert got["prefix_int8"]["warm_identical"]
    assert got["pages"]["int8"] > got["pages"]["float32"]
    assert len(got["points"]) == 2
