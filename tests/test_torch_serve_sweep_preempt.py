"""The serving sweep's preemption A/B with its fault-injected chaos sub-run:
the port's against the JAX package's root ``benchmarks/serve_sweep.py`` on
the CPU, at the qwen2-1.5b smoke config in float32 with the same weights.
Every field that is not a time is equal: per arm the interactive requests
completed and expired, the preempt/resume ledger (preemptions, resumes,
park hits, re-prefills, pages parked, deadlines expired), ticks, traces,
``token_identical`` against an unconstrained run and the page-leak gate on
both tiers; for the chaos run the faults injected by kind, completions,
cancels and expiries."""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import load_qwen, sweep_both  # noqa: E402


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


def test_preemption_scenario_matches_jax(qwen):
    got, _ = sweep_both("preemption_scenario", qwen)
    assert got["token_identical"] and got["page_leak_free"]
    assert got["preempt"]["preemptions"] > 0
    assert got["preempt"]["resumes"] == got["preempt"]["preemptions"]
    assert (got["preempt"]["interactive_completed"]
            > got["stall"]["interactive_completed"])
    assert got["chaos"]["faults_injected"] > 0


def test_preemption_scenario_without_chaos_matches_jax(qwen):
    got, _ = sweep_both("preemption_scenario", qwen, warm=False, chaos=False,
                        n_chats=4)
    assert "chaos" not in got
    assert got["token_identical"] and got["page_leak_free"]
