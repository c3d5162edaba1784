"""The port's serving autotuner (``repro_torch.core.autotune``) against the
JAX package's, on the CPU: ``select_serve_defaults`` returns the same
``best`` and the same whole table (every row's knobs, criteria, fractions
and scores, compared with ``==``: the same Python float arithmetic in the
same order) when both price the same card — the JAX ``HwSpec`` built from
the port's ``dataclasses.asdict(H100)``."""
import dataclasses

import pytest

from repro_torch.core import autotune as tat
from repro_torch.core.roofline import H100

CASES = {
    "qwen2-smoke": dict(arch="qwen2-1.5b", smoke=True),
    "qwen2-full": dict(arch="qwen2-1.5b", smoke=False),
    "qwen2-smoke-ctx100": dict(arch="qwen2-1.5b", smoke=True,
                               context_len=100),
    "qwen2-full-tier-spec": dict(arch="qwen2-1.5b", smoke=False,
                                 host_pool_pages=(0, 64), spec_ks=(0, 4)),
    "qwen1.5-4b-smoke-tp-tier-spec": dict(
        arch="qwen1.5-4b", smoke=True, device_counts=(1, 2, 4),
        host_pool_pages=(0, 64), spec_ks=(0, 4)),
    "gemma3-full-batch16": dict(arch="gemma3-4b", smoke=False, batch_size=16,
                                kv_dtypes=("bfloat16", "int8")),
}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from repro.core import autotune, roofline

    return autotune, roofline.HwSpec(**dataclasses.asdict(H100))


@pytest.mark.parametrize("case", list(CASES))
def test_select_serve_defaults_matches_jax(J, case):
    autotune, hw = J
    kw = dict(CASES[case])
    arch = kw.pop("arch")
    got = tat.select_serve_defaults(arch, **kw)
    want = autotune.select_serve_defaults(arch, hw=hw, **kw)
    assert got["best"] == want["best"]
    assert len(got["table"]) == len(want["table"]) > 0
    for r, w in zip(got["table"], want["table"]):
        assert r == w
    # the H100 is the default card
    assert tat.select_serve_defaults(arch, hw=H100, **kw)["best"] == got["best"]


def test_scheduler_model_matches_jax(J):
    assert tat.SCHEDULER_MODEL == J[0].SCHEDULER_MODEL


def test_no_candidate_raises_like_jax(J):
    autotune, hw = J
    kw = dict(smoke=True, batch_size=96, token_budgets=(64,))
    with pytest.raises(ValueError) as port:
        tat.select_serve_defaults("qwen2-1.5b", **kw)
    with pytest.raises(ValueError) as ref:
        autotune.select_serve_defaults("qwen2-1.5b", hw=hw, **kw)
    assert str(port.value) == str(ref.value)


def test_the_training_half_waits_for_the_mesh():
    """``Candidate``/``evaluate``/``select_defaults`` lower programs on a
    device mesh; the docstring says they wait and where."""
    for name in ("Candidate", "evaluate", "select_defaults"):
        assert not hasattr(tat, name)
        assert name in tat.__doc__
    assert "ROADMAP.md" in tat.__doc__
