"""The serving sweep's tensor-parallel scenario in the PyTorch port
(``benchmarks/serve_sweep.py --sharded-only``), on gloo rank processes.

At 1, 2 and 4 ranks (qwen1.5-4b smoke, seed-0 weights, the JAX sweep's
decode-heavy traffic) the transcripts are token-identical on every rank
and across counts, ``kv_shards`` reads 1, 2 and 4, one rank's pool bytes
are the pool's over the shard count, and the rows and JSON carry the
measured tokens/s.  JAX's roofline projection is absent (its HLO cost walk
is not ported).  ``tuned_serving_config_tp`` equals JAX's tuner over the
same device counts on the port's ``HwSpec``.  With ``--device cuda`` and
fewer cards than ranks the scenario raises.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.benchmarks import serve_sweep as TS  # noqa: E402
from repro_torch.core.roofline import H100  # noqa: E402


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    path = tmp_path_factory.mktemp("sweep") / "sharded.json"
    TS.main(["--sharded-only", "--device", "cpu", "--json", str(path)])
    with open(path) as f:
        return json.load(f)


def test_sharded_scenario_is_token_identical(sharded):
    sh = sharded["sharded_serve"]
    assert sh["arch"] == "qwen1.5-4b" and sh["device_counts"] == [1, 2, 4]
    assert sh["token_identical"] is True
    per = sh["per_device_count"]
    assert [per[n]["kv_shards"] for n in ("1", "2", "4")] == [1, 2, 4]
    assert [per[n]["n_devices"] for n in ("1", "2", "4")] == [1, 2, 4]
    for n in ("1", "2", "4"):
        r = per[n]
        assert r["kv_pool_bytes_per_device"] * r["kv_shards"] == \
            r["kv_pool_bytes"]
        assert r["measured_tokens_per_s"] > 0
        assert "projected_tokens_per_s" not in r
    assert sh["measured_speedup"] > 0 and "projected_speedup" not in sh


def test_sharded_rows(sharded):
    names = [r["name"] for r in sharded["rows"]]
    assert names == [f"serve/qwen1.5-4b/sharded/n_devices={n}"
                     for n in (1, 2, 4)] + [
        "serve/qwen1.5-4b/sharded/measured_speedup/4x-devices"]
    assert "token_identical=True" in sharded["rows"][-1]["derived"]


def test_tuned_tp_config_matches_jax(sharded):
    pytest.importorskip("jax")
    from repro.core import autotune, roofline

    hw = roofline.HwSpec(**dataclasses.asdict(H100))
    want = autotune.select_serve_defaults(
        "qwen1.5-4b", smoke=True, device_counts=(1, 2, 4), hw=hw)["best"]
    assert sharded["tuned_serving_config_tp"] == want


def test_sharded_on_cuda_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 ranks, 2 devices"):
        TS.sharded_serve_scenario(device="cuda")
    with pytest.raises(RuntimeError, match="4 ranks, 2 devices"):
        TS.main(["--sharded-only"])
