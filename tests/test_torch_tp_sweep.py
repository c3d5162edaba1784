"""The serving sweep's tensor-parallel scenario in the PyTorch port
(``benchmarks/serve_sweep.py --sharded-only``), on gloo rank processes.

At 1, 2 and 4 ranks (qwen1.5-4b smoke, seed-0 weights, the JAX sweep's
decode-heavy traffic) the transcripts are token-identical on every rank
and across counts, ``kv_shards`` reads 1, 2 and 4, one rank's pool bytes
are the pool's over the shard count, and the rows and JSON carry the
measured tokens/s and the roofline projection: rank 0's ragged step on
JAX's all-zero pack counted by ``core/op_cost.py``.  Its
``projected_speedup`` at 4 ranks, priced on JAX's ``HwSpec``, passes JAX's
own gate (>= 1.5).  ``per_device_flops`` equals JAX's HLO-walked step at 1
rank; at N ranks the port's exceeds JAX's by exactly (1 - 1/N) of the q, k
and v projections' FLOPs, which JAX splits over heads (each device projects
its own heads) and the port computes whole on every rank before taking its
heads.  ``tuned_serving_config_tp`` equals JAX's tuner over the same device
counts on the port's ``HwSpec``.  With ``--device cuda`` and fewer cards
than ranks the scenario raises.
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

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
        assert r["per_device_flops"] > 0 and r["per_device_bytes"] > 0
        tick_s = max(r["per_device_flops"] / H100.peak_flops,
                     r["per_device_bytes"] / H100.hbm_bw)
        assert r["projected_tokens_per_s"] == 4 / tick_s
    assert sh["measured_speedup"] > 0
    assert sh["projected_speedup"] == (
        per["4"]["projected_tokens_per_s"] / per["1"]["projected_tokens_per_s"])


def test_sharded_rows(sharded):
    names = [r["name"] for r in sharded["rows"]]
    assert names == [f"serve/qwen1.5-4b/sharded/n_devices={n}"
                     for n in (1, 2, 4)] + [
        "serve/qwen1.5-4b/sharded/projected_speedup/4x-devices",
        "serve/qwen1.5-4b/sharded/measured_speedup/4x-devices"]
    assert all("projected_tokens_per_s=" in r["derived"]
               for r in sharded["rows"][:3])
    assert "token_identical=True" in sharded["rows"][-1]["derived"]
    assert "token_identical=True" in sharded["rows"][-2]["derived"]


def test_projected_speedup_on_jax_hwspec(sharded):
    """JAX's gate, on JAX's ``HwSpec`` (V5E), from the port's counts."""
    pytest.importorskip("jax")
    from repro.core.roofline import V5E

    per = sharded["sharded_serve"]["per_device_count"]

    def tps(r):
        return 4 / max(r["per_device_flops"] / V5E.peak_flops,
                       r["per_device_bytes"] / V5E.hbm_bw)

    assert tps(per["4"]) / tps(per["1"]) >= 1.5


_JAX_STEP = """
import json, jax, numpy as np
from repro.configs import get_config
from repro.core import hlo_cost
from repro.models import model as M
from repro.serve.engine import ServeEngine

n = %d
cfg = get_config("qwen1.5-4b", smoke=True)
params = M.init_params(jax.random.PRNGKey(0), cfg)
kw = dict(batch_size=4, cache_len=256, page_size=16, prefill_chunk=16,
          token_budget=32)
if n > 1:
    from repro.launch.mesh import make_mesh
    kw["mesh"] = make_mesh((n,), ("model",))
eng = ServeEngine(params, cfg, **kw)
eng._ensure_state()
T, B = eng.budget, eng.B
pack = (np.zeros(T, np.int32),) * 4 + (np.zeros(T, bool), np.zeros(B, np.int32))
with eng._ctx():
    lowered = eng._ragged_step.lower(eng.params, eng._state, *pack)
print(json.dumps(hlo_cost.analyze(lowered.compile().as_text())))
"""


def test_per_device_flops_against_jax(sharded, multidevice):
    """JAX's sharded scenario's step, lowered at 1, 2 and 4 fake devices
    (the JAX scenario's settings, ``_ensure_state`` in place of the traffic, which
    leaves the step's shapes as they are).  Exact: at 1 rank equal; at N
    the port's is JAX's plus (1 - 1/N) of the q/k/v projections."""
    pytest.importorskip("jax")
    from repro_torch.configs import get_config

    with ThreadPoolExecutor(3) as ex:
        outs = list(ex.map(lambda n: multidevice(_JAX_STEP % n, n_devices=n),
                           (1, 2, 4)))
    jax_flops = {n: json.loads(o.strip().splitlines()[-1])["flops"]
                 for n, o in zip((1, 2, 4), outs)}
    cfg = get_config("qwen1.5-4b", smoke=True)
    attn = cfg.stages[0].pattern[0].attn
    layers = sum(st.repeats * len(st.pattern) for st in cfg.stages)
    T = 32  # the scenario's token budget
    qkv = 2.0 * T * cfg.d_model * attn.head_dim * (
        attn.num_heads + 2 * attn.num_kv_heads) * layers
    per = sharded["sharded_serve"]["per_device_count"]
    for n in (1, 2, 4):
        assert per[str(n)]["per_device_flops"] == \
            jax_flops[n] + qkv * (1 - 1 / n), (n, jax_flops)


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
