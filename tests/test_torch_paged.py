"""The port's two-phase serving path against the JAX package's, on the CPU.

- ``paged_flash_decode_ref`` (the plain version of the CUDA kernel) against
  the Pallas kernel ``repro.kernels.ops.paged_flash_decode`` run in
  interpret mode, on the cases of tests/test_kernels.py
  (``test_paged_flash_decode_allclose``: sentinel pages, a partial page, an
  empty slot) and an int8 case with scale pools.  Tolerance rtol = atol =
  2e-5 in float32; bfloat16 outputs 2e-2 (the JAX test's), and each output
  row within 1e-2 of its norm.
- ``paged_step`` logits and every state leaf against JAX on one prefill
  chunk and one decode tick (a freed slot rides along with a stale block
  table), float32 and int8 pools, kernel and gather routes: float leaves and
  logits at atol = rtol = 1e-4, integer leaves equal.
- ``ServeEngine(ragged=False)`` transcripts token-identical to the JAX
  engine's, ``flash_decode`` off and on, float32 and int8 pools, and the
  port's own ragged/two-phase A/B (``tests/test_serve.py``'s
  ``test_ragged_matches_chunked_two_phase``).
- A ``gpu`` test holding the CUDA kernel against the plain version; it
  skips where there is no card.

JAX is imported by fixtures, not at module level, so that the ``gpu`` test
also runs where only PyTorch is installed.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_flash_decode as pfd  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ROW_RTOL = 1e-2


def _row_rel_err(got, want) -> float:
    """Largest |got - want| / |want| over the output rows (the last axis),
    both taken in float32; an all-zero row of both counts 0."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


@pytest.fixture(scope="module")
def jax_ops():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops

    return types.SimpleNamespace(jnp=jnp, ops=ops)


@pytest.fixture(scope="module")
def qwen():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM

    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, JM=JM, cfg=cfg, tcfg=tcfg, jp=jp,
                                 tp=tp)


def _decode_case(page, pps, *, B=3, kvH=2, G=4, hd=16, seed=0):
    """test_kernels.py's decode case: a full slot, a slot with a partial
    page, an empty slot; unused block-table entries hold the sentinel
    ``npages``."""
    rng = np.random.RandomState(seed)
    npages = B * pps
    q = rng.standard_normal((B, kvH, G, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kvH, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvH, hd)).astype(np.float32)
    perm = rng.permutation(npages)
    ptab = np.full((B, pps), npages, np.int32)
    lens = np.asarray([pps * page, 1 + page // 2, 0], np.int32)
    for b in range(B):
        used = -(-int(lens[b]) // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    return q, kp, vp, ptab, lens


def _both(jx, q, kp, vp, ptab, lens, ks=None, vs=None):
    jnp = jx.jnp
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    j = jx.ops.paged_flash_decode(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(ptab),
                                  jnp.asarray(lens), ks=opt(ks), vs=opt(vs))
    topt = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    t = pfd.paged_flash_decode_ref(
        *(torch.from_numpy(np.array(a)) for a in (q, kp, vp, ptab, lens)),
        ks=topt(ks), vs=topt(vs))
    return np.asarray(j.astype(jnp.float32)), t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page,pps", [(8, 4), (16, 2)])
def test_decode_ref_matches_pallas_kernel(jax_ops, page, pps, dtype):
    q, kp, vp, ptab, lens = _decode_case(page, pps)
    assert (ptab == kp.shape[0]).any() and (lens == 0).any()
    assert (lens % page != 0).any()  # a partial page
    if dtype == "bfloat16":
        jnp = jax_ops.jnp
        q, kp, vp = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, kp, vp))
        j = jax_ops.ops.paged_flash_decode(
            *(jnp.asarray(a) for a in (q, kp, vp, ptab, lens)))
        t = pfd.paged_flash_decode_ref(
            *(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
              for a in (q, kp, vp)),
            torch.from_numpy(ptab), torch.from_numpy(lens))
        assert t.dtype == torch.bfloat16
        j, t = np.asarray(j.astype(jnp.float32)), t.float().numpy()
        tol = dict(rtol=2e-2, atol=2e-2)
        assert _row_rel_err(torch.tensor(t), torch.tensor(j)) <= BF16_ROW_RTOL
    else:
        j, t = _both(jax_ops, q, kp, vp, ptab, lens)
        tol = TOL
    np.testing.assert_allclose(t, j, **tol)
    np.testing.assert_array_equal(t[lens == 0], 0.0)  # the empty slot


def test_decode_ref_int8_fused_dequant_matches_pallas_kernel(jax_ops):
    q, kp, vp, ptab, lens = _decode_case(8, 3)
    kp8, ks = jax_ops.ops.quantize_kv(kp)
    vp8, vs = jax_ops.ops.quantize_kv(vp)
    j, t = _both(jax_ops, q, kp8, vp8, ptab, lens, ks, vs)
    np.testing.assert_allclose(t, j, **TOL)


def test_decode_ref_equals_ragged_ref_with_one_token_per_slot():
    """Kernel 2 computes what kernel 1 does for the pack ``slot = arange(B)``
    (a decode tick is a ragged pack of one token per slot;
    tests/test_torch_decode.py holds the two CUDA kernels together on the
    card)."""
    from repro_torch.kernels import ragged_paged_flash as rpf

    args = [torch.from_numpy(a) for a in _decode_case(8, 4)]
    q, kp, vp, ptab, lens = args
    slot = torch.arange(q.shape[0], dtype=torch.int32)
    torch.testing.assert_close(
        pfd.paged_flash_decode_ref(q, kp, vp, ptab, lens),
        rpf.ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens), rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    args = [torch.from_numpy(a) for a in _decode_case(8, 4)]
    before = pfd.launches
    got = tops.paged_flash_decode(*args)
    assert pfd.launches == before
    torch.testing.assert_close(got, pfd.paged_flash_decode_ref(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["lens_dtype", "lens_shape", "ptab_rows",
                                 "q_dtype", "int8_without_scales",
                                 "noncontiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    q, kp, vp, ptab, lens = (torch.from_numpy(a) for a in _decode_case(8, 4))
    if bad == "lens_dtype":
        lens = lens.long()
    elif bad == "lens_shape":
        lens = lens[:2]
    elif bad == "ptab_rows":
        ptab = ptab[:2]
    elif bad == "q_dtype":
        q = q.half()
    elif bad == "int8_without_scales":
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        tops.paged_flash_decode(q, kp, vp, ptab, lens)


# ---------------------------------------------------------------------------
# paged_step against JAX


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _compare_states(q, jstate, tstate):
    want = _flat(q.jax.tree.map(np.asarray, jstate))
    got = _flat(bridge.state_to_numpy(tstate, q.tcfg))
    assert got.keys() == want.keys()
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP_TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_step_matches_jax(qwen, kv_dtype, flash):
    """A prefill chunk (slot 0 a full chunk, slot 1 a short one with an
    invalid tail, slot 2 idle), then slot 2 is freed with its block table
    and ``slen`` left stale, then a decode tick for slots 0 and 1 with slot
    2 riding along invalid: logits and every state leaf after each step."""
    jnp = qwen.jax.numpy
    cfg, tcfg, JM = qwen.cfg, qwen.tcfg, qwen.JM
    B, cache_len, P, n_pages, C = 3, 64, 8, 24, 8
    pps = cache_len // P
    js = JM.init_paged_state(qwen.jp, cfg, B, cache_len, page_size=P,
                             n_pages=n_pages, kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(qwen.jax.tree.map(np.asarray, js), tcfg, "cpu")
    rows = np.full((B, pps), n_pages, np.int32)
    rows[0, :2] = [3, 17]
    rows[1, :2] = [5, 11]
    rows[2, :2] = [14, 2]
    mask, plen = np.ones(B, bool), np.zeros(B, np.int32)
    js = JM.reset_paged_slots(cfg, js, js, jnp.asarray(mask), jnp.asarray(rows),
                              jnp.asarray(plen))
    TM.reset_paged_slots(tcfg, ts, {"layers": [[{}]]}, torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    rng = np.random.RandomState(11)

    # slot 2 wrote 10 tokens earlier (a gather-route step on both sides)
    tokens = rng.randint(0, cfg.vocab_size, (B, 10)).astype(np.int32)
    q_pos = np.tile(np.arange(10, dtype=np.int32), (B, 1))
    valid = np.zeros((B, 10), bool)
    valid[2] = True
    steps = [(tokens, q_pos, valid, False)]
    tokens = rng.randint(0, cfg.vocab_size, (B, C)).astype(np.int32)
    q_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    valid = np.zeros((B, C), bool)
    valid[0], valid[1, :5] = True, True
    steps.append((tokens, q_pos, valid, False))
    tokens = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    q_pos = np.asarray([[C], [5], [0]], np.int32)
    valid = np.asarray([[True], [True], [False]])
    steps.append((tokens, q_pos, valid, True))
    for i, (tok, qp, va, with_logits) in enumerate(steps):
        route = flash and i > 0
        jl, js = JM.paged_step(qwen.jp, cfg, js, *(jnp.asarray(a) for a in (tok, qp, va)),
                               with_logits=with_logits, flash_decode=route)
        tl, ts = TM.paged_step(qwen.tp, tcfg, ts,
                               *(torch.from_numpy(a) for a in (tok, qp, va)),
                               with_logits=with_logits, flash_decode=route)
        if with_logits:
            assert tl.shape == (B, 1, cfg.vocab_size)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
        else:
            assert tl is None and jl is None
        _compare_states(qwen, js, ts)
    # the freed slot kept its stale fill count and block table
    assert int(ts["layers"][0][0]["slen"][0, 2]) == 10


def test_paged_step_updates_state_in_place(qwen):
    tcfg = qwen.tcfg
    ts = TM.init_paged_state(qwen.tp, tcfg, 2, 32, page_size=8, n_pages=8,
                             kv_dtype="int8")
    leaves = [t for ss in ts["layers"] for c in ss for t in c.values()]
    ptrs = [t.data_ptr() for t in leaves]
    rows = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    TM.reset_paged_slots(tcfg, ts, {"layers": [[{}]]}, torch.ones(2, dtype=torch.bool),
                         rows, torch.zeros(2, dtype=torch.int32))
    tokens = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    q_pos = torch.arange(3, dtype=torch.int32).repeat(2, 1)
    _, out = TM.paged_step(qwen.tp, tcfg, ts, tokens, q_pos,
                           torch.ones(2, 3, dtype=torch.bool), with_logits=False)
    assert out is ts
    assert [t.data_ptr() for t in leaves] == ptrs
    assert ts["layers"][0][0]["slen"][0].tolist() == [3, 3]


# ---------------------------------------------------------------------------
# the two-phase engine


KW = dict(batch_size=2, cache_len=64, page_size=8, prefill_chunk=16,
          token_budget=32)


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
def test_two_phase_transcripts_token_identical_to_jax_engine(qwen, kv_dtype,
                                                             flash):
    from repro.serve.engine import ServeEngine as JaxEngine

    waves = _waves(qwen.cfg.vocab_size)
    je = JaxEngine(qwen.jp, qwen.cfg, ragged=False, flash_decode=flash,
                   kv_dtype=kv_dtype, **KW)
    te = ServeEngine(qwen.tp, qwen.tcfg, ragged=False, flash_decode=flash,
                     kv_dtype=kv_dtype, device="cpu", **KW)
    assert _serve(te, waves) == _serve(je, waves)
    ts, js = te.stats, je.stats
    for key in ("chunk_ticks", "decode_ticks", "ragged_ticks", "ticks",
                "prefix_hits", "prefix_tokens_reused", "cow_copies",
                "admissions", "pages_in_use_peak", "evictions"):
        assert ts[key] == js[key], key
    assert ts["chunk_ticks"] > 0 and ts["decode_ticks"] > 0
    assert ts["ragged_ticks"] == 0
    assert ts["prefix_hits"] >= 2 and ts["cow_copies"] >= 1
    assert ts["kernel_launches"] == 0  # the CPU runs the plain version
    assert te.pool.pages_in_use == 0 and te.reclaimable_pages == te.n_pages


def test_ragged_matches_two_phase(qwen):
    """The port's A/B: the ragged engine and the two-phase engine emit
    identical greedy tokens on identical traffic (tests/test_serve.py's
    ``test_ragged_matches_chunked_two_phase``, on the port)."""
    rng = np.random.RandomState(24)
    prompts = [rng.randint(0, qwen.cfg.vocab_size, L) for L in (26, 9, 17, 5)]
    out = []
    for ragged in (True, False):
        eng = ServeEngine(qwen.tp, qwen.tcfg, batch_size=3, cache_len=64,
                          page_size=8, prefill_chunk=16, ragged=ragged,
                          device="cpu")
        uids = [eng.submit(p, max_tokens=4) for p in prompts]
        res = eng.run()
        out.append([res[u] for u in uids])
    assert out[0] == out[1]


def test_two_phase_skips_the_budget_check_and_still_refuses_spec(qwen):
    """As in JAX: ``token_budget >= batch_size`` binds the ragged path
    only, and speculative decoding needs the ragged path (``ValueError``
    for ``spec_k`` with ``ragged=False``)."""
    te = ServeEngine(qwen.tp, qwen.tcfg, batch_size=4, token_budget=2,
                     ragged=False, device="cpu")
    assert te.ragged is False
    with pytest.raises(ValueError, match="token_budget"):
        ServeEngine(qwen.tp, qwen.tcfg, batch_size=4, token_budget=2,
                    device="cpu")
    with pytest.raises(ValueError, match="ragged path"):
        ServeEngine(qwen.tp, qwen.tcfg, ragged=False, spec_k=2, device="cpu")


def test_launcher_serves_the_chunked_engine(capsys):
    assert tserve.main(["--engine", "chunked", "--device", "cpu",
                        "--requests", "3", "--batch-size", "2",
                        "--max-tokens", "3", "--flash-decode"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "'decode_ticks': " in out
    # the lock-step engine serves too, with no stats line (as JAX's)
    assert tserve.main(["--engine", "reference", "--device", "cpu",
                        "--requests", "2", "--batch-size", "2",
                        "--max-tokens", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "stats:" not in out


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_kernel_matches_plain_version(q_dtype, kv_dtype):
    """The hand-written CUDA kernel against ``paged_flash_decode_ref`` on the
    card, at qwen2-1.5b's head shape (G 6, hd 128), with sentinel pages and
    an empty slot, at 4 and at 128 pages per slot (a 2048-token slot).
    Tolerance: float32 outputs rtol = atol = 1e-4; bfloat16 outputs atol =
    2e-2, compared in float32, and each output row (one slot, KV head and
    query head) within ``BF16_ROW_RTOL`` of its norm: a long slot averages
    many keys, so its values are small (|o| ~ 0.036 at 2048 tokens)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for pps in (4, 128):
        q, kp, vp, ptab, lens = (torch.from_numpy(a).cuda()
                                 for a in _decode_case(16, pps, G=6, hd=128))
        ks = vs = None
        if kv_dtype == "int8":
            kp, ks = tops.quantize_kv(kp)
            vp, vs = tops.quantize_kv(vp)
        q = q.to(getattr(torch, q_dtype))
        kp, vp = kp.to(getattr(torch, kv_dtype)), vp.to(getattr(torch, kv_dtype))
        before = pfd.launches
        got = pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)
        torch.cuda.synchronize()
        assert pfd.launches == before + 1
        want = pfd.paged_flash_decode_ref(q, kp, vp, ptab, lens, ks=ks, vs=vs)
        tol = (dict(rtol=1e-4, atol=1e-4) if q_dtype == "float32"
               else dict(rtol=0.0, atol=2e-2))
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if q_dtype == "bfloat16":
            assert _row_rel_err(got, want) <= BF16_ROW_RTOL, pps
        assert bool((got[lens == 0] == 0).all())
