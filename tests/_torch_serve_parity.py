"""Shared pieces of the serving parity tests of the PyTorch port
(tests/test_torch_tiered.py, test_torch_preempt.py, test_torch_chaos.py,
test_torch_sched.py): the JAX package imported lazily — so that ``pytest -m
gpu`` runs where there is no JAX — the qwen2-1.5b smoke config's seed-0
weights in float32 on both sides (bridged through numpy), and the checks
both engines are held to."""
import types

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.configs import get_config as tget

# the JAX tier/preemption/chaos tests' engine defaults
ENGINE_KW = dict(cache_len=64, page_size=8, prefill_chunk=16,
                 token_budget=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's smoke-sized torch work on one intra-op thread: with
    several test workers on one machine, each worker's default of one
    thread per core oversubscribes the cores many times over."""
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_pkg():
    """The JAX package's serving pieces (skips where JAX is missing)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model
    from repro.serve import chaos, errors, handle, pool, scheduler
    from repro.serve.engine import ServeEngine

    return types.SimpleNamespace(jax=jax, get_config=get_config, M=model,
                                 chaos=chaos, errors=errors, handle=handle,
                                 pool=pool, sched=scheduler,
                                 Engine=ServeEngine)


def load_qwen():
    """(JAX cfg, port cfg, JAX params, port params): the qwen2-1.5b smoke
    config at float32 activations, the same seed-0 weights on both sides."""
    J = jax_pkg()
    cfg = J.get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jp = J.M.init_params(J.jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(J.jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, L) for L in lens]


def assert_stats_equal(port, jax_stats):
    """Every key of the JAX engine's merged ``stats`` (engine counters and
    the pool's) holds the same value in the port's."""
    ts = port.stats
    for key, want in jax_stats.items():
        assert ts[key] == want, (key, ts[key], want)


def leak_free(eng) -> bool:
    """Both tiers drained: no page referenced, every device page
    reclaimable, no park left, host slots partitioned free/resident, and
    the engine's host bytes exactly the pool's host residency."""
    pool = eng.pool
    return bool((pool._ref == 0).all()
                and eng.reclaimable_pages == eng.n_pages
                and pool.parked_pages == 0
                and sorted(pool._host_free + list(pool._host_node))
                == list(range(pool.host_pages))
                and eng._host_slots == set(pool._host_node))


def outcome(handles):
    """What each request ended with: its tokens and, for an abort, the
    error's type name — comparable across the two packages."""
    out = []
    for h in handles:
        r = h.request
        err = None if r.error is None else type(r.error).__name__
        out.append((list(r.out_tokens), err, bool(r.cancelled)))
    return out
