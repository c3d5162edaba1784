"""The port's serving-sweep entry point (``python -m
repro_torch.benchmarks.serve_sweep``) on the CPU: ``--smoke --device cpu
--json`` writes a payload with the JAX sweep's keys — each scenario's
result with JAX's fields, rows as JAX's row builders make them, and the
tuned config the port's ``select_serve_defaults`` picks, equal to the JAX
tuner's on the same card; the tensor-parallel flags raise until the mesh
lands (ROADMAP.md, Queue 1)."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import jax_sweep, time_keys  # noqa: E402

from repro_torch.benchmarks import serve_sweep as TS  # noqa: E402
from repro_torch.core.roofline import H100  # noqa: E402


@pytest.fixture(scope="module")
def payloads(tmp_path_factory):
    """(the port's --smoke payload on the CPU, the JAX sweep's
    --tiered-only payload: the same top-level keys, every scenario but
    the tiered one left None)."""
    d = tmp_path_factory.mktemp("sweep")
    TS.main(["--smoke", "--json", str(d / "port.json"), "--device", "cpu"])
    jax_sweep().main(["--tiered-only", "--json", str(d / "jax.json")])
    return tuple(json.loads((d / f"{n}.json").read_text())
                 for n in ("port", "jax"))


def test_smoke_payload_has_jax_keys(payloads):
    port, ref = payloads
    assert list(port) == list(ref)
    assert port["grid"] == {"users": [4], "page_sizes": [8], "max_tokens": 4,
                            "cache_len": 128}
    assert port["preemption"] is None
    for key in ("latency_under_concurrent_prefill", "prefix_scenario",
                "kv_dtype_ab", "scheduler_ab", "tiered_kv", "speculative"):
        assert port[key] is not None, key
    # the tiered scenario's fields, nested keys included, are JAX's
    assert time_keys(port["tiered_kv"]) == time_keys(ref["tiered_kv"])
    assert port["tiered_kv"].keys() == ref["tiered_kv"].keys()


def test_smoke_rows_are_jax_rows(payloads):
    port, _ = payloads
    S = jax_sweep()
    rows = [(r["name"], r["tokens_per_s"], r["derived"])
            for r in port["rows"]]
    names = [r[0] for r in rows]
    arch = "qwen2-1.5b"
    for builder, key in ((S._tiered_rows, "tiered_kv"),
                         (S._spec_rows, "speculative")):
        built = builder(arch, port[key])
        assert all(r in rows for r in built), key
    for part in ("seed/users=4", "chunked/users=4/page=8",
                 "ragged/users=4/page=8", "latency/p50-improvement",
                 "prefix/speedup", "scheduler/slo-p50-ratio",
                 "kv-ab/speedup/users=10/max_tokens=16"):
        assert f"serve/{arch}/{part}" in names, part
    assert "-of-bound" in dict((n, d) for n, _, d in rows)[
        f"serve/{arch}/ragged/users=4/page=8"]


def test_tuned_config_matches_jax_tuner(payloads):
    port, _ = payloads
    pytest.importorskip("jax")
    from repro.core import autotune, roofline

    hw = roofline.HwSpec(**dataclasses.asdict(H100))
    want = autotune.select_serve_defaults(
        "qwen2-1.5b", smoke=True, host_pool_pages=(0, 64), spec_ks=(0, 4),
        hw=hw)["best"]
    assert port["tuned_serving_config"] == want


@pytest.mark.parametrize("flag", ["--sharded", "--sharded-only"])
def test_sharded_flags_raise_until_the_mesh_lands(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.main(["--smoke", flag, "--device", "cpu"])
    assert not hasattr(TS, "sharded_serve_scenario")


def test_sweep_serves_on_the_card_unless_told(monkeypatch):
    """``--device`` defaults to cuda, and the port never falls back to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main(["--tiered-only"])
