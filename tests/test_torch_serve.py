"""The port's ServeEngine against the JAX ServeEngine, on the CPU.

Greedy transcripts must be token-identical on the same weights (bridged),
float32 activations, for float32 and int8 pools and for both attention
routes (``flash_decode`` False and True on both engines), across a cold
wave and a warm wave that hits the prefix cache mid-page (copy-on-write).
Beside parity: pools never move (the in-place contract), no page leaks
after completion and cancellation, and the engine refuses to run without a
card unless asked for the CPU.  Tensor parallelism (``mesh=``) is held
against JAX in tests/test_torch_tp_serve.py and test_torch_tp_features.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.errors import (DeadlineExceeded,  # noqa: E402
                                      EngineOverloaded, RequestTooLarge)

KW = dict(batch_size=2, cache_len=64, page_size=8, prefill_chunk=16,
          token_budget=32)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _waves(vocab, seed=0):
    """Cold wave: mixed lengths, more requests than slots, one prompt that
    seeds a 20-token prefix.  Warm wave: a full-page hit plus a mid-page
    hit (copy-on-write), and a cold prompt."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, 20)
    cold = [rng.randint(0, vocab, L) for L in (5, 17, 30, 9)]
    cold.append(np.concatenate([shared, rng.randint(0, vocab, 3)]))
    warm = [np.concatenate([shared, rng.randint(0, vocab, 4)]),
            np.concatenate([shared[:13], rng.randint(0, vocab, 6)]),
            rng.randint(0, vocab, 11)]
    return cold, warm


def _serve(engine, waves, max_tokens=6):
    out = []
    for wave in waves:
        uids = [engine.submit(p, max_tokens=max_tokens) for p in wave]
        res = engine.run()
        out.append([res[u] for u in uids])
    return out


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_transcripts_token_identical_to_jax_engine(qwen, kv_dtype, flash):
    cfg, tcfg, jp, tp = qwen
    waves = _waves(cfg.vocab_size)
    je = JaxEngine(jp, cfg, flash_decode=flash, kv_dtype=kv_dtype, **KW)
    te = ServeEngine(tp, tcfg, flash_decode=flash, kv_dtype=kv_dtype,
                     device="cpu", **KW)
    assert _serve(te, waves) == _serve(je, waves)
    ts, js = te.stats, je.stats
    for key in ("prefix_hits", "prefix_tokens_reused", "cow_copies",
                "admissions", "ragged_ticks", "packed_tokens",
                "pages_in_use_peak", "kv_pool_bytes", "kv_bytes_per_token",
                "evictions", "traces"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] >= 2 and ts["cow_copies"] >= 1
    assert ts["kernel_launches"] == 0  # the CPU runs the plain version
    assert set(js) <= set(ts)  # the JAX engine's stats keys, plus the port's


def test_eviction_under_page_pressure_matches_jax_engine(qwen):
    """A pool too small to keep the cold wave's prefixes cached: admission
    must evict the same LRU pages as the JAX pool and serve the same
    tokens."""
    cfg, tcfg, jp, tp = qwen
    waves = _waves(cfg.vocab_size, seed=3)
    kw = dict(KW, max_pages=10)
    je = JaxEngine(jp, cfg, **kw)
    te = ServeEngine(tp, tcfg, device="cpu", **kw)
    assert _serve(te, waves) == _serve(je, waves)
    ts, js = te.stats, je.stats
    assert ts["evictions"] == js["evictions"] > 0
    assert ts["prefix_hits"] == js["prefix_hits"]
    assert te.pool.pages_in_use == 0 and te.reclaimable_pages == 10


def test_pools_keep_their_addresses(qwen):
    _, tcfg, _, tp = qwen
    te = ServeEngine(tp, tcfg, kv_dtype="int8", device="cpu", **KW)
    pools = te.pool_tensors()
    assert len(pools) == 4  # kp, vp, ks, vs of the one stacked stage
    ptrs = [t.data_ptr() for t in pools]
    _serve(te, _waves(tcfg.vocab_size, seed=1))
    assert [t.data_ptr() for t in te.pool_tensors()] == ptrs
    assert te.pool_tensors()[0] is pools[0]


def test_no_page_leak_after_completion_and_cancel(qwen):
    _, tcfg, _, tp = qwen
    te = ServeEngine(tp, tcfg, device="cpu", **KW)
    cold, warm = _waves(tcfg.vocab_size, seed=2)
    handles = [te.submit(p, max_tokens=8) for p in cold + warm]
    te.tick()
    te.tick()
    assert handles[0].cancel()  # mid-flight: holds pages
    assert handles[-1].cancel()  # still queued
    te.run()
    assert te.pool.pages_in_use == 0
    assert te.reclaimable_pages == te.n_pages
    assert te.stats["cancelled"] == 2
    te.drop_prefix_cache()
    assert te.pool.free_pages == te.n_pages


def test_submit_errors_and_deadlines(qwen):
    _, tcfg, _, tp = qwen
    te = ServeEngine(tp, tcfg, device="cpu", max_queue=2, **KW)
    with pytest.raises(RequestTooLarge):
        te.submit(np.arange(60), max_tokens=8)
    h = te.submit(np.arange(10), max_tokens=30, deadline_ticks=3)
    te.submit(np.arange(5), max_tokens=2)
    with pytest.raises(EngineOverloaded):
        te.submit(np.arange(5), max_tokens=2)
    with pytest.raises(DeadlineExceeded) as err:
        h.result()
    assert 0 < len(err.value.tokens) < 30
    te.run()
    assert te.pool.pages_in_use == 0


def test_engine_needs_a_card_unless_asked_for_cpu(qwen):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, tcfg, _, tp = qwen
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tp, tcfg, **KW)
