"""Sliding-window attention in the port against the JAX package, on the
CPU, and the serving kernels at gemma3's head layout on the card.

CPU, gemma3-4b's smoke config (two windowed layers, window 16, then a
global one) in float32, the same seed-0 weights on both sides through
``repro_torch.bridge``:

- ``init_params`` builds it and lays it out like JAX's pytree;
  ``attention_fwd`` with a window on its full and chunked routes (flash is
  gated off for windows, as in JAX): rtol = atol = 1e-5; ``forward``,
  ``loss_fn`` and every gradient leaf: logits and loss rtol = atol = 1e-4,
  gradients rtol 1e-4, atol 1e-5 x the leaf's max |g|;
- the ragged and two-phase steps with chunks longer than the window,
  float32 and int8 pools, both routes, a slot re-admitted mid-run: logits
  and every state leaf at rtol = atol = 1e-4 (integer and int8 leaves
  equal);
- served transcripts equal the JAX engine's and the port's own solo
  lock-step decode (``ReferenceEngine`` at batch 1) — ports of
  tests/test_serve.py's ``test_windowed_layers_mixed_lengths`` and
  ``test_ragged_mixed_concurrent_matches_reference`` — and the engine's
  gates (prefix cache, speculation, preemption, host tier, page budget)
  and merged stats equal the JAX engine's key for key.

``gpu`` tests (skipped where there is no card): both serving kernels
against their plain versions at gemma3's head layout (4 KV heads, 2 query
heads each, head_dim 256: the ``simt`` variant), bf16 q over bf16 and int8
pools.  JAX is imported lazily (fixtures), so that ``pytest -m gpu`` runs
where there is no JAX.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import assert_stats_equal  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE = 64


def _load(arch, **replace):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine as JaxEngine

    cfg = get_config(arch, smoke=True).replace(dtype="float32", **replace)
    tcfg = tget(arch, smoke=True).replace(dtype="float32", **replace)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(np_params, tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JM=JM, Engine=JaxEngine,
                                 cfg=cfg, tcfg=tcfg, jp=jp, tp=tp,
                                 np_params=np_params)


@pytest.fixture(scope="module")
def gemma():
    return _load("gemma3-4b")


@pytest.fixture(scope="module")
def qwen():
    return _load("qwen2-1.5b")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _compare_states(m, jstate, tstate):
    want = _flat(m.jax.tree.map(np.asarray, jstate))
    got = _flat(bridge.state_to_numpy(tstate, m.tcfg))
    assert got.keys() == want.keys()
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _compare_trees(got, want, rtol, atol_frac):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        a = atol_frac * float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=a,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Parameters and the full-sequence path


def test_init_params_builds_gemma3_like_jax(gemma):
    """The config that raised before windows were ported: random weights
    on the CPU, laid out like JAX's pytree."""
    want = {k: v.shape for k, v in _flat(gemma.np_params).items()}
    cfg = tget("gemma3-4b", smoke=True)
    for params in (TM.init_params(cfg, device="cpu"), gemma.tp):
        got = {k: v.shape for k, v in
               _flat(bridge.params_to_numpy(params, cfg)).items()}
        assert got == want


@pytest.mark.parametrize("route,q_chunk,use_flash", [
    ("full", 128, False), ("chunked", 16, False), ("flash-gated", 128, True)])
def test_windowed_attention_fwd_matches_jax(gemma, route, q_chunk, use_flash):
    """A windowed layer's ``attention_fwd`` over 64 positions (window 16):
    the full softmax, the chunked softmax (64 > 2 x 16), and ``use_flash``,
    which windows leave on the softmax routes in both packages."""
    from repro.models.layers import attention as JA

    jnp = gemma.jnp
    acfg = gemma.cfg.stages[0].pattern[0].attn
    tacfg = gemma.tcfg.stages[0].pattern[0].attn
    assert acfg.window == tacfg.window == 16
    mixer = {k: np.array(v) for k, v in
             gemma.np_params["stages"][0][0]["mixer"].items()}
    x = np.random.RandomState(7).standard_normal((2, 64, gemma.cfg.d_model)
                                                 ).astype(np.float32)
    want = JA.attention_fwd({k: jnp.asarray(v) for k, v in mixer.items()}, acfg,
                            jnp.asarray(x), q_chunk=q_chunk, use_flash=use_flash)
    from repro_torch.kernels import flash_attention as tfa

    before = tfa.launches
    got = TA.attention_fwd({k: torch.from_numpy(v) for k, v in mixer.items()},
                           tacfg, torch.from_numpy(x), q_chunk=q_chunk,
                           use_flash=use_flash)
    assert tfa.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_loss_and_grads_match_jax(gemma, remat):
    """Training at 64 positions, four windows long: logits, loss and every
    gradient leaf against ``jax.value_and_grad``."""
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLMData

    jax, jnp = gemma.jax, gemma.jnp
    batch = SyntheticLMData(gemma.cfg, ShapeCfg("t", 64, 2, "train"),
                            seed=1).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits, _ = gemma.JM.forward(gemma.jp, gemma.cfg, jb)
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: gemma.JM.loss_fn(p, gemma.cfg, jb), has_aux=True)(gemma.jp)
    tcfg = gemma.tcfg.replace(remat=remat)
    params = bridge.params_from_numpy(gemma.np_params, tcfg, "cpu",
                                      for_training=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = TM.forward(params, tcfg, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    loss, _ = TM.loss_fn(params, tcfg, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    _compare_trees(bridge.grads_to_numpy(params, grads, tcfg),
                   jax.tree.map(np.asarray, want_grads), rtol=1e-4,
                   atol_frac=1e-5)


# ---------------------------------------------------------------------------
# The serving steps


B, P, NPAGES, C = 3, 8, 30, 24  # slots, page, pool pages, prefill chunk


def _fresh(m, kv_dtype):
    """JAX's and the port's fresh serving states (windowed buffers C
    entries past the window, as the engines make them) and the port's reset
    template (a windowed buffer's fresh value, 0)."""
    js = m.JM.init_paged_state(m.jp, m.cfg, B, CACHE, page_size=P,
                               n_pages=NPAGES, window_extra=C,
                               kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), m.tcfg, "cpu")
    tmpl = {"layers": [[{k: 0 for k in ("k", "v") if k in c} for c in ss]
                       for ss in ts["layers"]]}
    return js, ts, tmpl


def _reset(m, js, j0, ts, tmpl, mask, rows):
    """Admit the masked slots on both sides (no inherited prefix)."""
    jnp = m.jnp
    plen = np.zeros(B, np.int32)
    js = m.JM.reset_paged_slots(m.cfg, js, j0, jnp.asarray(mask),
                                jnp.asarray(rows), jnp.asarray(plen))
    TM.reset_paged_slots(m.tcfg, ts, tmpl, torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    return js


def _rows():
    rows = np.full((B, CACHE // P), NPAGES, np.int32)
    for b in range(B):
        rows[b] = np.arange(CACHE // P) + b * (CACHE // P)
    return rows


def _pack(rng, cursor, chunks, T, vocab):
    """A ragged pack of (slot, count) runs at each slot's next positions,
    an invalid entry after the first run, an invalid tail; logit_idx at
    each listed slot's last token."""
    tokens = rng.randint(0, vocab, T).astype(np.int32)
    slot, q_pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    seq, valid = np.zeros(T, np.int32), np.zeros(T, bool)
    logit_idx = np.full(B, T, np.int32)
    n = 0
    for i, (b, c) in enumerate(chunks):
        slot[n:n + c], q_pos[n:n + c] = b, cursor[b] + np.arange(c)
        seq[n:n + c], valid[n:n + c] = np.arange(c), True
        logit_idx[b] = n + c - 1
        cursor[b] += c
        n += c + (i == 0)
    assert n < T
    return tokens, slot, q_pos, seq, valid, logit_idx


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ragged_step_matches_jax(gemma, kv_dtype, flash):
    """Packs whose runs outgrow the window (a 24-token chunk against window
    16, then runs that wrap the buffers again) beside decode tokens; after
    the third pack slot 1 is re-admitted and starts over.  Logits and every
    state leaf after each pack; the windowed buffers stay in float32 under
    int8 pools."""
    m = gemma
    jnp = m.jnp
    js, ts, tmpl = _fresh(m, kv_dtype)
    j0 = js
    js = _reset(m, js, j0, ts, tmpl, np.ones(B, bool), _rows())
    rng = np.random.RandomState(7)
    cursor = [0] * B
    plan = [[(0, 24), (1, 10), (2, 3)], [(0, 1), (1, 24), (2, 20)],
            [(2, 1), (0, 22), (1, 1)], None, [(1, 24), (0, 1), (2, 24)],
            [(0, 1), (1, 1), (2, 1)]]
    for chunks in plan:
        if chunks is None:  # slot 1 finishes; a new request takes it
            js = _reset(m, js, j0, ts, tmpl, np.asarray([False, True, False]),
                        _rows())
            cursor[1] = 0
            _compare_states(m, js, ts)
            continue
        vecs = _pack(rng, cursor, chunks, 64, m.cfg.vocab_size)
        jl, js = m.JM.ragged_step(m.jp, m.cfg, js, *(jnp.asarray(a) for a in vecs),
                                  width=C + 1, flash_decode=flash)
        tl, ts = TM.ragged_step(m.tp, m.tcfg, ts,
                                *(torch.from_numpy(a) for a in vecs),
                                width=C + 1, flash_decode=flash)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
    assert ts["layers"][0][0]["k"].dtype == torch.float32
    assert max(cursor) > 16 + C  # the buffers wrapped


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_step_matches_jax(gemma, kv_dtype, flash):
    """The two-phase path: two (B, 24) prefill chunks (slot 0 full, slot 1
    a short one with an invalid tail, slot 2 idle), then decode ticks for
    slots 0 and 1 with slot 2 riding along invalid (the global layer's
    through the decode kernel's plain version with ``flash``).  Logits and
    every state leaf after each step."""
    m = gemma
    jnp = m.jnp
    js, ts, tmpl = _fresh(m, kv_dtype)
    js = _reset(m, js, js, ts, tmpl, np.ones(B, bool), _rows())
    rng = np.random.RandomState(11)
    fill = [0, 0]
    steps = []
    for n1 in (24, 7):
        tok = rng.randint(0, m.cfg.vocab_size, (B, C)).astype(np.int32)
        q_pos = np.stack([fill[0] + np.arange(C), fill[1] + np.arange(C),
                          np.arange(C)]).astype(np.int32)
        valid = np.zeros((B, C), bool)
        valid[0], valid[1, :n1] = True, True
        fill = [fill[0] + C, fill[1] + n1]
        steps.append((tok, q_pos, valid, False))
    for _ in range(3):
        tok = rng.randint(0, m.cfg.vocab_size, (B, 1)).astype(np.int32)
        q_pos = np.asarray([[fill[0]], [fill[1]], [0]], np.int32)
        steps.append((tok, q_pos, np.asarray([[True], [True], [False]]), True))
        fill = [fill[0] + 1, fill[1] + 1]
    for tok, qp, va, with_logits in steps:
        route = flash and with_logits
        jl, js = m.JM.paged_step(m.jp, m.cfg, js,
                                 *(jnp.asarray(a) for a in (tok, qp, va)),
                                 with_logits=with_logits, flash_decode=route)
        tl, ts = TM.paged_step(m.tp, m.tcfg, ts,
                               *(torch.from_numpy(a) for a in (tok, qp, va)),
                               with_logits=with_logits, flash_decode=route)
        if with_logits:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)


# ---------------------------------------------------------------------------
# Served transcripts and the engine's gates


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in lens]


def _solo(m, prompt, max_tokens):
    """The port's own ground truth: the lock-step engine at batch 1."""
    ref = ReferenceEngine(m.tp, m.tcfg, batch_size=1, cache_len=CACHE,
                          device="cpu")
    uid = ref.submit(prompt, max_tokens=max_tokens)
    return ref.run()[uid]


def _both(m, prompts, max_tokens=4, **kw):
    """The JAX and the port engine on the same traffic: (JAX transcripts,
    the port's, JAX's stats, the port engine)."""
    kw = {**dict(batch_size=2, cache_len=CACHE, page_size=8), **kw}
    je = m.Engine(m.jp, m.cfg, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **kw)
    out = []
    for eng in (je, te):
        uids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
        res = eng.run()
        out.append([res[u] for u in uids])
    return out[0], out[1], je.stats, te


@pytest.fixture(scope="module")
def windowed_solo(gemma):
    prompts = _prompts(gemma.cfg.vocab_size, [33, 7, 21], seed=2)
    return prompts, [_solo(gemma, p, 4) for p in prompts]


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_windowed_layers_mixed_lengths(gemma, windowed_solo, ragged, kv_dtype,
                                       flash):
    """Prompts longer than the window (a 24-token chunk wraps within one
    write): transcripts equal the JAX engine's and the port's solo
    lock-step decode; merged stats equal JAX's key for key."""
    prompts, solo = windowed_solo
    want, got, jstats, te = _both(gemma, prompts, prefill_chunk=24,
                                  ragged=ragged, flash_decode=flash,
                                  kv_dtype=kv_dtype)
    assert got == want == solo
    assert_stats_equal(te, jstats)


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-4b"])
def test_ragged_mixed_concurrent_matches_reference(qwen, gemma, arch, flash):
    """Mixed-length concurrent traffic through the ragged pack (budget 24):
    every request equals the JAX engine's and the port's lock-step engine
    run solo; one trace, as JAX counts it."""
    m = qwen if arch == "qwen2-1.5b" else gemma
    prompts = _prompts(m.cfg.vocab_size, [5, 19, 11, 26, 8], seed=21)
    want, got, jstats, te = _both(m, prompts, prefill_chunk=16,
                                  token_budget=24, flash_decode=flash)
    assert got == want == [_solo(m, p, 4) for p in prompts]
    assert te.stats["traces"] == jstats["traces"] == 1
    assert_stats_equal(te, jstats)


GATE_KW = [dict(), dict(spec_k=2), dict(host_pages=16), dict(kv_dtype="int8"),
           dict(ragged=False, preempt=True), dict(max_pages=20)]


@pytest.mark.parametrize("kw", GATE_KW, ids=lambda kw: ",".join(kw) or "default")
def test_engine_gates_match_jax(gemma, kw):
    """Prefix cache, speculation, preemption and the host tier are off for
    a windowed model, silently, as in JAX; the page budget and pool bytes
    count the global layer only.  Every attribute and stat equal JAX's,
    before and after serving."""
    m = gemma
    kw = {**dict(batch_size=2, cache_len=CACHE, page_size=8, prefill_chunk=16,
                 token_budget=32), **kw}
    je = m.Engine(m.jp, m.cfg, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **kw)
    for name in ("prefix_cache", "_spec_k", "preempt", "host_pages", "n_pages",
                 "_has_paged"):
        assert getattr(te, name) == getattr(je, name), name
    assert not te.prefix_cache and te._spec_k == 0 and not te.preempt
    assert te.host_pages == 0 and te.stats["spec_k"] == 0
    assert_stats_equal(te, je.stats)
    prompts = _prompts(m.cfg.vocab_size, [20, 9], seed=4)
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_tokens=3)
        eng.run()
    assert_stats_equal(te, je.stats)


def test_model_without_paged_layers_reserves_no_pages(gemma):
    """Every layer windowed (gemma3's local layer, twice): the pool takes
    one block table per slot of pages and a request reserves none (JAX
    ``_pages_needed``); transcripts and stats equal JAX's."""
    from repro.configs.base import Stage as JStage

    from repro_torch.configs import Stage
    from repro_torch.serve.handle import Request

    m = gemma
    cfg = m.cfg.replace(stages=(JStage(m.cfg.stages[0].pattern[:1], 2),))
    tcfg = m.tcfg.replace(stages=(Stage(m.tcfg.stages[0].pattern[:1], 2),))
    jp = m.JM.init_params(m.jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(m.jax.tree.map(np.asarray, jp), tcfg, "cpu")
    local = types.SimpleNamespace(**{**vars(m), "cfg": cfg, "tcfg": tcfg,
                                     "jp": jp, "tp": tp})
    prompts = _prompts(cfg.vocab_size, [30, 12, 5], seed=5)
    want, got, jstats, te = _both(local, prompts, prefill_chunk=16)
    assert got == want
    assert te.n_pages == 2 * CACHE // 8
    assert te._pages_needed(Request(0, prompts[0], 4)) == 0
    assert_stats_equal(te, jstats)


# ---------------------------------------------------------------------------
# On the card: the serving kernels at gemma3's head layout


KVH, G, HD = 4, 2, 256  # gemma3-4b: 8 query heads over 4 KV heads


def _card_pools(kv_dtype, n_pages, page, seed):
    rng = np.random.RandomState(seed)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, page, KVH, HD)).astype(np.float32)).cuda() for _ in range(2))
    ks = vs = None
    if kv_dtype == "int8":
        kp, ks = tops.quantize_kv(kp)
        vp, vs = tops.quantize_kv(vp)
    dt = getattr(torch, kv_dtype)
    return kp.to(dt), vp.to(dt), ks, vs


def _card_ptab(lens_per_slot, page, pps, n_pages, seed):
    """Block tables mapping only the pages each slot's length reaches
    (the rest the sentinel ``n_pages``), in shuffled page order."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_pages)
    ptab = np.full((len(lens_per_slot), pps), n_pages, np.int32)
    for b, n in enumerate(lens_per_slot):
        used = -(-n // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    return torch.from_numpy(ptab).cuda()


def _row_rel_err(got, want):
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cuda_ragged_kernel_at_gemma3_head_layout(kv_dtype):
    """Kernel 1 on a ragged pack at gemma3's head layout: decode tokens of
    slots 0-3 at lengths up to 1024, a 40-token chunk of slot 4 crossing
    key splits, an invalid tail.  bf16 q, tolerance atol 2e-2 (compared in
    float32) and each output row within 1e-2 of its norm; ``simt``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ragged_paged_flash as rpf

    page, pps, nslots = 16, 64, 5
    fills = [1023, 700, 300, 17, 500]
    lens = [fills[b] + 1 for b in range(4)] + list(range(501, 541))
    slot = list(range(4)) + [4] * 40
    T = 64
    lens += [0] * (T - len(lens))
    slot += [0] * (T - len(slot))
    n_pages = nslots * pps
    kp, vp, ks, vs = _card_pools(kv_dtype, n_pages, page, seed=1)
    ptab = _card_ptab([fills[b] + 1 for b in range(4)] + [540], page, pps,
                      n_pages, seed=2)
    q = torch.randn(T, KVH, G, HD, generator=torch.Generator().manual_seed(3)
                    ).cuda().to(torch.bfloat16)
    slot_t = torch.tensor(slot, dtype=torch.int32, device="cuda")
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    assert rpf.ragged_variant(q.dtype, kp.dtype, HD) == "simt"
    rpf.reset_launches()
    got = rpf.ragged_paged_flash(q, kp, vp, ptab, slot_t, lens_t, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert rpf.launches == rpf.launches_by_variant["simt"] == 1
    want = rpf.ragged_paged_flash_ref(q, kp, vp, ptab, slot_t, lens_t,
                                      ks=ks, vs=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
    assert _row_rel_err(got[lens_t > 0], want[lens_t > 0]) <= 1e-2
    assert bool((got[lens_t == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cuda_decode_kernel_at_gemma3_head_layout(kv_dtype):
    """Kernel 2 on a decode tick at gemma3's head layout: 8 slots at
    lengths up to 2048 and an empty one.  bf16 q, tolerance atol 2e-2
    (compared in float32) and each output row within 1e-2 of its norm;
    ``simt``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import paged_flash_decode as pfd

    page, pps = 16, 128
    lens = [2048, 1500, 1101, 701, 421, 201, 65, 0]
    n_pages = len(lens) * pps
    kp, vp, ks, vs = _card_pools(kv_dtype, n_pages, page, seed=4)
    ptab = _card_ptab(lens, page, pps, n_pages, seed=5)
    q = torch.randn(len(lens), KVH, G, HD,
                    generator=torch.Generator().manual_seed(6)
                    ).cuda().to(torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    assert pfd.kernel_variant(q, kp, vp) == "simt"
    pfd.reset_launches()
    got = pfd.paged_flash_decode(q, kp, vp, ptab, lens_t, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert pfd.launches == pfd.launches_by_variant["simt"] == 1
    want = pfd.paged_flash_decode_ref(q, kp, vp, ptab, lens_t, ks=ks, vs=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
    assert _row_rel_err(got[lens_t > 0], want[lens_t > 0]) <= 1e-2
    assert bool((got[lens_t == 0] == 0).all())
