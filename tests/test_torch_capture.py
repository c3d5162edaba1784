"""The captured serving step: what the capture needs, on the CPU, and the
capture itself on the card.

CPU (the qwen2-1.5b smoke config):

- under a ``TorchDispatchMode`` recorder, the ragged step (with (B,) and,
  speculative, (B, R) ``logit_idx``), the speculative rollback, the prefill
  chunk step and the decode tick dispatch no ``aten.index``/``index_put``
  with a boolean index and no ``aten.nonzero``, ``_local_scalar_dense`` or
  ``masked_select`` — the ops that copy a count to the host and cannot be
  captured — for float32 and int8 pools and both attention routes;
- an all-invalid pack (the capture's warm-up pack) leaves every state leaf
  bit-identical;
- packs in which dropped writes clamp onto the targets of live writes (the
  ragged tail at slot 0, position 0 while slot 0 prefills from 0; pages
  clamped onto the pool's last page, which a live slot owns) write what the
  JAX package's steps write: logits and float leaves within atol = rtol =
  1e-4 in float32, integer and int8 leaves equal;
- the same for gemma3's smoke config (windowed layers, window 16): its
  ragged, chunk and decode steps and an admission's slot reset;
- the recorder and the all-invalid pack over xlstm-350m's smoke config
  (mLSTM and sLSTM mixers): the ragged step's (B, width) repack and
  masked roll, the two-phase steps' masked rolls, the slot reset;
- a ``CapturedStep``'s static inputs keep their ``data_ptr()`` across
  ticks, and ``stats["traces"]`` is 1 once the ragged step has run, as
  the JAX engine counts traces.

``gpu`` tests (skipped where there is no card): captured and eager
engines give token-identical transcripts for the ragged and two-phase
paths, float32/bfloat16/int8 pools and both routes; ``traces`` is 1 on the
ragged engine; the pools never move; ``kernel_launches`` is the number of
layers times the kernel's ticks (for a windowed model, of its global
layers); one eager step under
``torch.cuda.set_sync_debug_mode("error")`` raises nothing; a dead engine
in a reference cycle does not break another engine's capture.  JAX is
imported lazily (a fixture), so that ``pytest -m gpu`` runs where there is
no JAX.
"""
import gc
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.util import dense_lm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import serve_step as SS  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# batch, cache_len, page, n_pages, ragged pack size, prefill chunk
B, CACHE, P, NPAGES, T, C = 3, 64, 8, 24, 24, 8
PPS = CACHE // P

_HOST_SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense",
                  "aten::masked_select")


class _Recorder(TorchDispatchMode):
    """Records every dispatched op that would make the host wait: the
    ops above, and ``index``/``index_put`` with a boolean or byte index
    (which run ``nonzero``)."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in _HOST_SYNC_OPS:
            self.bad.append(name)
        elif name.startswith(("aten::index", "aten::_index_put")):
            indices = args[1] if len(args) > 1 else ()
            if isinstance(indices, (list, tuple)) and any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8) for i in indices):
                self.bad.append(f"{name} with a boolean index")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def smoke():
    cfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _state(cfg, params, kv_dtype, *, rows=None):
    """A paged state whose three slots map the given block-table rows."""
    state = TM.init_paged_state(params, cfg, B, CACHE, page_size=P,
                                n_pages=NPAGES, kv_dtype=kv_dtype)
    if rows is None:
        rows = np.full((B, PPS), NPAGES, np.int32)
        rows[:, :3] = np.arange(3 * B).reshape(B, 3) + 2
    TM.reset_paged_slots(cfg, state, {"layers": [[{}]]},
                         torch.ones(B, dtype=torch.bool),
                         torch.from_numpy(rows), torch.zeros(B, dtype=torch.int32))
    return state


def _ragged_pack(seed=0, vocab=512):
    """Slot 0 prefills 5 tokens from 0, slot 1 prefills 3, slot 2 decodes
    at 7; an invalid entry between slots, an invalid tail."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, T).astype(np.int32)
    slot = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    seq = np.full(T, C + 1, np.int32)
    valid = np.zeros(T, bool)
    logit_idx = np.full(B, T, np.int32)
    n = 0
    for b, start, c in ((0, 0, 5), (1, 0, 3), (2, 7, 1)):
        slot[n:n + c], q_pos[n:n + c] = b, start + np.arange(c)
        seq[n:n + c], valid[n:n + c] = np.arange(c), True
        logit_idx[b] = n + c - 1
        n += c + (b == 0)  # an invalid entry after slot 0
    return [tokens, slot, q_pos, seq, valid, logit_idx]


# verify rows a slot in the speculative ragged step (1 + spec_k)
R = 3


def _verify_pack(seed=0, vocab=512):
    """``_ragged_pack`` plus slot 2's two draft tokens at positions 8 and 9
    as a run of their own, ``logit_idx`` (B, R)."""
    tokens, slot, q_pos, seq, valid, last = _ragged_pack(seed, vocab)
    logit_idx = np.full((B, R), T, np.int32)
    logit_idx[:, 0] = last
    n = int(valid.nonzero()[0].max()) + 1
    slot[n:n + 2], q_pos[n:n + 2] = 2, [8, 9]
    seq[n:n + 2], valid[n:n + 2] = [1, 2], True
    logit_idx[2, 1:] = [n, n + 1]
    return [tokens, slot, q_pos, seq, valid, logit_idx]


def _paged_pack(width, seed=0, vocab=512):
    """(B, width): slot 0 full, slot 1 an invalid tail, slot 2 idle."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (B, width)).astype(np.int32)
    q_pos = np.tile(np.arange(width, dtype=np.int32), (B, 1))
    valid = np.zeros((B, width), bool)
    valid[0], valid[1, :max(1, width // 2)] = True, True
    return [tokens, q_pos, valid]


def _steps(cfg, params, state, flash):
    """The three serving steps as ``CapturedStep``s (eager on the CPU)."""
    kw = dict(flash_decode=flash)
    return {
        "ragged": SS.capture_ragged_step(cfg, params, state, T=T, B=B,
                                         width=C + 1, **kw),
        "verify": SS.capture_ragged_step(cfg, params, state, T=T, B=B,
                                         width=C + 1, R=R, **kw),
        "rollback": SS.capture_spec_rollback(cfg, state, B=B, device="cpu"),
        "chunk": SS.capture_paged_step(cfg, params, state, B=B, C=C,
                                       with_logits=False, **kw),
        "decode": SS.capture_paged_step(cfg, params, state, B=B, C=1,
                                        with_logits=True, **kw),
    }


def _pack_for(kind, seed=0):
    if kind == "ragged":
        return _ragged_pack(seed)
    if kind == "verify":
        return _verify_pack(seed)
    if kind == "rollback":  # slots 0 and 2 lose what lies past 2 and 8 + seed
        return [np.asarray([True, False, True]),
                np.asarray([2, 0, 8 + seed], np.int32)]
    return _paged_pack(C if kind == "chunk" else 1, seed)


KINDS = ["ragged", "verify", "rollback", "chunk", "decode"]


def test_recorder_sees_a_boolean_index():
    x = torch.arange(6.0)
    with _Recorder() as rec:
        x[x > 2] = 0.0
        _ = x[torch.tensor([True, False] * 3)]
        x[torch.tensor([1, 2])] = 1.0
    assert len(rec.bad) >= 2 and all("boolean" in b or "nonzero" in b
                                     for b in rec.bad), rec.bad


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_steps_dispatch_no_host_synchronising_op(smoke, kind, kv_dtype, flash):
    cfg, params = smoke
    state = _state(cfg, params, kv_dtype)
    steps = _steps(cfg, params, state, flash)
    # a real pack first: state to read (rows for the rollback to kill)
    first = "verify" if kind == "rollback" else kind
    steps[first].run(*_pack_for(first, seed=1))
    step = steps[kind]
    with _Recorder() as rec:
        step.run(*_pack_for(kind, seed=2))
    assert rec.bad == []


@pytest.fixture(scope="module")
def windowed():
    """gemma3-4b's smoke config (two windowed layers, window 16, then a
    global one) in float32, seed-0 weights."""
    cfg = tget("gemma3-4b", smoke=True).replace(dtype="float32")
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _windowed_state(cfg, params, kv_dtype):
    """A serving state with windowed buffers ``C`` entries past the window
    (as the engine makes them), its three slots admitted."""
    state = TM.init_paged_state(params, cfg, B, CACHE, page_size=P,
                                n_pages=NPAGES, window_extra=C,
                                kv_dtype=kv_dtype)
    rows = np.full((B, PPS), NPAGES, np.int32)
    rows[:, :3] = np.arange(3 * B).reshape(B, 3) + 2
    tmpl = {"layers": [[{k: 0 for k in ("k", "v") if k in c} for c in ss]
                       for ss in state["layers"]]}
    TM.reset_paged_slots(cfg, state, tmpl, torch.ones(B, dtype=torch.bool),
                         torch.from_numpy(rows), torch.zeros(B, dtype=torch.int32))
    return state, tmpl, rows


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["ragged", "chunk", "decode", "reset"])
def test_windowed_steps_dispatch_no_host_synchronising_op(windowed, kind,
                                                          kv_dtype, flash):
    """The same recorder over a windowed model's steps (its circular-buffer
    writes and attention) and over an admission's slot reset (a windowed
    buffer filled from its template's 0)."""
    cfg, params = windowed
    state, tmpl, rows = _windowed_state(cfg, params, kv_dtype)
    steps = {k: v for k, v in _steps(cfg, params, state, flash).items()
             if k in ("ragged", "chunk", "decode")}
    steps["ragged"].run(*_ragged_pack(seed=1))
    with _Recorder() as rec:
        if kind == "reset":
            TM.reset_paged_slots(cfg, state, tmpl,
                                 torch.tensor([False, True, False]),
                                 torch.from_numpy(rows),
                                 torch.zeros(B, dtype=torch.int32))
        else:
            steps[kind].run(*_pack_for(kind, seed=2))
    assert rec.bad == []


def _leaves(state):
    return {f"{i}.{j}.{k}": v.clone()
            for i, ss in enumerate(state["layers"])
            for j, c in enumerate(ss) for k, v in c.items()}


@pytest.fixture(scope="module")
def recurrent():
    """xlstm-350m's smoke config (two stacked repeats of an mLSTM and an
    sLSTM block) in float32, seed-0 weights."""
    cfg = tget("xlstm-350m", smoke=True).replace(dtype="float32")
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _recurrent_state(cfg, params):
    """A recurrent serving state, its three slots admitted (from the
    template: the sLSTM stabilizer at -1e30)."""
    state = TM.init_paged_state(params, cfg, B, CACHE, page_size=P,
                                n_pages=NPAGES)
    tmpl = TM.reset_template(state)
    rows = np.full((B, PPS), NPAGES, np.int32)
    TM.reset_paged_slots(cfg, state, tmpl, torch.ones(B, dtype=torch.bool),
                         torch.from_numpy(rows), torch.zeros(B, dtype=torch.int32))
    return state, tmpl, rows


@pytest.mark.parametrize("kind", ["ragged", "chunk", "decode", "reset"])
def test_recurrent_steps_dispatch_no_host_synchronising_op(recurrent, kind):
    """The recorder over a recurrent model's steps — the ragged step's
    scatter into the (B, width) layout, the masked roll of ``width`` steps
    and the gather back; the two-phase steps' masked rolls — and over an
    admission's slot reset (the recurrent leaves from their template)."""
    cfg, params = recurrent
    state, tmpl, rows = _recurrent_state(cfg, params)
    steps = {k: v for k, v in _steps(cfg, params, state, False).items()
             if k in ("ragged", "chunk", "decode")}
    steps["ragged"].run(*_ragged_pack(seed=1))
    with _Recorder() as rec:
        if kind == "reset":
            TM.reset_paged_slots(cfg, state, tmpl,
                                 torch.tensor([False, True, False]),
                                 torch.from_numpy(rows),
                                 torch.zeros(B, dtype=torch.int32))
        else:
            steps[kind].run(*_pack_for(kind, seed=2))
    assert rec.bad == []


@pytest.mark.parametrize("kind", ["ragged", "chunk", "decode"])
def test_recurrent_all_invalid_pack_leaves_the_state_bit_identical(recurrent,
                                                                   kind):
    """The capture's warm-up pack on a recurrent model, after a real pack
    advanced every slot: no slot's state moves."""
    cfg, params = recurrent
    state, _, _ = _recurrent_state(cfg, params)
    steps = _steps(cfg, params, state, False)
    steps["ragged"].run(*_ragged_pack(seed=3))
    before = _leaves(state)
    idle = {"ragged": lambda: SS.idle_ragged_pack(T, B, C + 1),
            "chunk": lambda: SS.idle_paged_pack(B, C),
            "decode": lambda: SS.idle_paged_pack(B, 1)}[kind]()
    steps[kind].run(*idle)
    after = _leaves(state)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k




@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_all_invalid_pack_leaves_the_state_bit_identical(smoke, kind, kv_dtype,
                                                         flash):
    cfg, params = smoke
    state = _state(cfg, params, kv_dtype)
    steps = _steps(cfg, params, state, flash)
    steps["ragged"].run(*_ragged_pack(seed=3))  # fill some pages first
    before = _leaves(state)
    idle = {"ragged": lambda: SS.idle_ragged_pack(T, B, C + 1),
            "verify": lambda: SS.idle_ragged_pack(T, B, C + 1, R),
            "rollback": lambda: [np.zeros(B, bool), np.zeros(B, np.int32)],
            "chunk": lambda: SS.idle_paged_pack(B, C),
            "decode": lambda: SS.idle_paged_pack(B, 1)}[kind]()
    steps[kind].run(*idle)
    after = _leaves(state)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k


@pytest.fixture(scope="module")
def jax_qwen():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM

    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JM=JM, cfg=cfg,
                                 tcfg=tcfg, jp=jp, tp=tp)


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
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _clashing_rows():
    """Slot 0 owns the pool's LAST page first, where every dropped write
    clamps; slot 2 maps one page, so its later positions hit the sentinel
    (dropped, clamped onto that same last page)."""
    rows = np.full((B, PPS), NPAGES, np.int32)
    rows[0, :2] = [NPAGES - 1, 4]
    rows[1, :2] = [7, 9]
    rows[2, :1] = [12]
    return rows


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ragged_duplicate_targets_write_what_jax_writes(jax_qwen, kv_dtype,
                                                        flash):
    """Tail entries carry slot 0, position 0 while slot 0 prefills from
    position 0 onto the pool's last page: the dropped kpos writes and the
    dropped pool writes land on live targets.  Slot 2 writes past its one
    mapped page (dropped), onto the same clamped page."""
    q = jax_qwen
    jnp, JM = q.jnp, q.JM
    js = JM.init_paged_state(q.jp, q.cfg, B, CACHE, page_size=P,
                             n_pages=NPAGES, kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(q.jax.tree.map(np.asarray, js), q.tcfg, "cpu")
    rows, mask, plen = _clashing_rows(), np.ones(B, bool), np.zeros(B, np.int32)
    js = JM.reset_paged_slots(q.cfg, js, js, jnp.asarray(mask),
                              jnp.asarray(rows), jnp.asarray(plen))
    TM.reset_paged_slots(q.tcfg, ts, {"layers": [[{}]]}, torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    step = SS.capture_ragged_step(q.tcfg, q.tp, ts, T=T, B=B, width=C + 1,
                                  flash_decode=flash)
    rng = np.random.RandomState(5)
    packs = [_ragged_pack(seed=5)]
    # slot 2 runs on past its page (positions 8..13), slot 0 decodes on
    tokens = rng.randint(0, q.cfg.vocab_size, T).astype(np.int32)
    slot, q_pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    seq, valid = np.full(T, C + 1, np.int32), np.zeros(T, bool)
    slot[:7], q_pos[:7] = [0] + [2] * 6, [5] + list(range(8, 14))
    seq[:7], valid[:7] = [0] + list(range(6)), True
    packs.append([tokens, slot, q_pos, seq, valid,
                  np.asarray([0, T, 6], np.int32)])
    for vecs in packs:
        jl, js = JM.ragged_step(q.jp, q.cfg, js, *(jnp.asarray(a) for a in vecs),
                                width=C + 1, flash_decode=flash)
        tl = step.run(*vecs)
        live = vecs[5] < T
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
        _compare_states(q, js, ts)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_duplicate_targets_write_what_jax_writes(jax_qwen, kv_dtype):
    """The two-phase chunk: slot 0 fills the pool's last page; slot 1's
    invalid tail and idle slot 2 clamp onto it."""
    q = jax_qwen
    jnp, JM = q.jnp, q.JM
    js = JM.init_paged_state(q.jp, q.cfg, B, CACHE, page_size=P,
                             n_pages=NPAGES, kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(q.jax.tree.map(np.asarray, js), q.tcfg, "cpu")
    rows, mask, plen = _clashing_rows(), np.ones(B, bool), np.zeros(B, np.int32)
    js = JM.reset_paged_slots(q.cfg, js, js, jnp.asarray(mask),
                              jnp.asarray(rows), jnp.asarray(plen))
    TM.reset_paged_slots(q.tcfg, ts, {"layers": [[{}]]}, torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    chunk = SS.capture_paged_step(q.tcfg, q.tp, ts, B=B, C=C, with_logits=False)
    decode = SS.capture_paged_step(q.tcfg, q.tp, ts, B=B, C=1, with_logits=True)
    vecs = _paged_pack(C, seed=6)
    _, js = JM.paged_step(q.jp, q.cfg, js, *(jnp.asarray(a) for a in vecs),
                          with_logits=False)
    chunk.run(*vecs)
    _compare_states(q, js, ts)
    tok = np.asarray([[3], [4], [5]], np.int32)
    pos = np.asarray([[C], [C // 2], [0]], np.int32)
    live = np.asarray([[True], [True], [False]])
    jl, js = JM.paged_step(q.jp, q.cfg, js, *(jnp.asarray(a) for a in (tok, pos, live)))
    tl = decode.run(tok, pos, live)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2, -1], **TOL)
    _compare_states(q, js, ts)


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_static_inputs_keep_their_addresses(smoke, ragged):
    cfg, params = smoke
    eng = ServeEngine(params, cfg, batch_size=2, cache_len=64, page_size=8,
                      prefill_chunk=16, token_budget=32, ragged=ragged,
                      device="cpu")
    eng.pool_tensors()  # builds the steps
    steps = ([eng._ragged_step] if ragged
             else [eng._chunk_step, eng._decode_step])
    ptrs = [[t.data_ptr() for t in s.inputs] for s in steps]
    rng = np.random.RandomState(0)
    for n in (5, 20, 9):
        eng.submit(rng.randint(0, cfg.vocab_size, n), max_tokens=4)
    eng.run()
    assert [[t.data_ptr() for t in s.inputs] for s in steps] == ptrs
    st = eng.stats
    assert st["traces"] == (1 if ragged else 0)  # as the JAX engine counts
    assert st["graph_captures"] == 0  # nothing is captured on the CPU
    assert not any(s.captured for s in steps)


# ---------------------------------------------------------------------------
# On the card


def _card_cfg(act):
    """A small dense decoder at head_dim 64, so that bf16 runs the serving
    kernels' tensor-core variant."""
    return dense_lm("capture-test", n_layers=2, d_model=256, n_heads=4,
                    n_kv=2, head_dim=64, d_ff=512, vocab=512, qkv_bias=True,
                    rope_theta=1e4, tie=True, max_seq_len=256).replace(dtype=act)


def _card_serve(eng, vocab):
    rng = np.random.RandomState(4)
    shared = rng.randint(0, vocab, 20)
    waves = [[rng.randint(0, vocab, n) for n in (5, 40, 17, 9)]
             + [np.concatenate([shared, rng.randint(0, vocab, 3)])],
             [np.concatenate([shared, rng.randint(0, vocab, 6)]),
              np.concatenate([shared[:13], rng.randint(0, vocab, 4)])]]
    out = []
    for wave in waves:
        uids = [eng.submit(p, max_tokens=8) for p in wave]
        res = eng.run()
        out.append([res[u] for u in uids])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("act,kv_dtype", [("float32", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("bfloat16", "int8")])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_captured_engine_matches_eager_engine(ragged, act, kv_dtype, flash):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _card_cfg(act)
    params = TM.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    kw = dict(batch_size=3, cache_len=128, page_size=16, prefill_chunk=16,
              token_budget=32, ragged=ragged, flash_decode=flash,
              kv_dtype=kv_dtype, device="cuda")
    eager = ServeEngine(params, cfg, cuda_graph=False, **kw)
    graph = ServeEngine(params, cfg, **kw)
    ptrs = [t.data_ptr() for t in graph.pool_tensors()]
    want = _card_serve(eager, cfg.vocab_size)
    assert _card_serve(graph, cfg.vocab_size) == want
    assert [t.data_ptr() for t in graph.pool_tensors()] == ptrs
    st, se = graph.stats, eager.stats
    assert st["traces"] == se["traces"] == (1 if ragged else 0)
    assert st["graph_captures"] == (1 if ragged else 2)
    assert se["graph_captures"] == 0
    ticks = st["ragged_ticks"] if ragged else st["decode_ticks"]
    assert ticks > 0 and ticks == (se["ragged_ticks"] if ragged
                                   else se["decode_ticks"])
    launches = cfg.n_layers * ticks if flash else 0
    assert st["kernel_launches"] == se["kernel_launches"] == launches


def _card_windowed_cfg(act):
    """gemma3's interleave cut small: two stacked repeats of (windowed,
    windowed, global) layers, window 32, head_dim 64 (the global layers'
    bf16 kernels take the tensor-core variant)."""
    from repro_torch.configs import Stage
    from repro_torch.configs.util import attn_block

    local = attn_block(4, 2, 64, 512, window=32, rope_theta=1e4)
    glob = attn_block(4, 2, 64, 512, rope_theta=1e6)
    base = _card_cfg(act)
    return base.replace(name="capture-window-test",
                        stages=(Stage((local, local, glob), 2),))


@pytest.mark.gpu
@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("act,kv_dtype", [("float32", "float32"),
                                          ("bfloat16", "bfloat16"),
                                          ("bfloat16", "int8")])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_captured_windowed_engine_matches_eager_engine(ragged, act, kv_dtype,
                                                       flash):
    """A windowed model served captured and eagerly: equal transcripts (the
    40-token prompt wraps the 48-entry buffers), the pools in place, and
    kernel launches only in the global layers, one each a kernel tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _card_windowed_cfg(act)
    params = TM.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    kw = dict(batch_size=3, cache_len=128, page_size=16, prefill_chunk=16,
              token_budget=32, ragged=ragged, flash_decode=flash,
              kv_dtype=kv_dtype, device="cuda")
    eager = ServeEngine(params, cfg, cuda_graph=False, **kw)
    graph = ServeEngine(params, cfg, **kw)
    assert not graph.prefix_cache
    ptrs = [t.data_ptr() for t in graph.pool_tensors()]
    want = _card_serve(eager, cfg.vocab_size)
    assert _card_serve(graph, cfg.vocab_size) == want
    assert [t.data_ptr() for t in graph.pool_tensors()] == ptrs
    st, se = graph.stats, eager.stats
    assert st["graph_captures"] == (1 if ragged else 2)
    ticks = st["ragged_ticks"] if ragged else st["decode_ticks"]
    assert ticks > 0 and ticks == (se["ragged_ticks"] if ragged
                                   else se["decode_ticks"])
    launches = 2 * ticks if flash else 0  # two global layers
    assert st["kernel_launches"] == se["kernel_launches"] == launches


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_captured_recurrent_engine_matches_eager_engine(ragged, act):
    """xlstm-350m's smoke config served captured and eagerly: equal
    transcripts over two waves (the second reuses slots, whose state the
    reset restores), one graph per step, no attention kernel, and the
    recurrent states in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tget("xlstm-350m", smoke=True).replace(dtype=act)
    params = TM.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    kw = dict(batch_size=3, cache_len=128, page_size=16, prefill_chunk=16,
              token_budget=32, ragged=ragged, flash_decode=True, device="cuda")
    eager = ServeEngine(params, cfg, cuda_graph=False, **kw)
    graph = ServeEngine(params, cfg, **kw)
    graph.pool_tensors()  # builds and captures the steps
    ptrs = [t.data_ptr() for ss in graph._state["layers"] for c in ss
            for t in c.values()]
    want = _card_serve(eager, cfg.vocab_size)
    assert _card_serve(graph, cfg.vocab_size) == want
    assert [t.data_ptr() for ss in graph._state["layers"] for c in ss
            for t in c.values()] == ptrs
    st, se = graph.stats, eager.stats
    assert st["graph_captures"] == (1 if ragged else 2)
    assert st["kernel_launches"] == se["kernel_launches"] == 0


class _ReleasingGraph(torch.cuda.graph):
    """``torch.cuda.graph`` that, once its capture has begun, hands what
    ``held`` holds to a fresh reference cycle and drops every other
    reference to it, with the collector set to run at every allocation:
    the collector's next run frees it, inside the capture unless the
    collector is off."""

    held: list = []

    def __enter__(self):
        out = super().__enter__()
        box = list(self.held)
        box.append(box)
        self.held.clear()
        gc.set_threshold(1, 1, 1)
        return out


@pytest.mark.gpu
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_capture_survives_a_dead_engine_in_a_reference_cycle(ragged,
                                                              monkeypatch):
    """A captured engine whose last reference, from a reference cycle,
    goes once another engine's capture has begun, with the collector set
    to run at every allocation: its graphs, events and pinned buffers must
    not be freed inside that capture.  The capture completes and the new
    engine serves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _card_cfg("bfloat16")
    params = TM.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    kw = dict(batch_size=3, cache_len=128, page_size=16, prefill_chunk=16,
              token_budget=32, ragged=ragged, flash_decode=True, device="cuda")
    dead = ServeEngine(params, cfg, **kw)
    dead.pool_tensors()  # captures its steps
    _ReleasingGraph.held[:] = [dead]
    del dead
    monkeypatch.setattr(torch.cuda, "graph", _ReleasingGraph)
    thresholds = gc.get_threshold()
    try:
        eng = ServeEngine(params, cfg, **kw)
        eng.pool_tensors()
    finally:
        gc.set_threshold(*thresholds)
        _ReleasingGraph.held.clear()
    assert eng.stats["graph_captures"] == (1 if ragged else 2)
    uid = eng.submit(np.arange(20) % cfg.vocab_size, max_tokens=3)
    assert len(eng.run()[uid]) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["ragged", "chunk", "decode"])
def test_eager_step_makes_no_host_synchronisation(kind, kv_dtype, flash):
    """One eager step of each kind under sync debug mode "error", which
    raises on any host synchronisation (``.item()``, ``nonzero``, a
    blocking copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _card_cfg("bfloat16")
    params = TM.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    state = TM.init_paged_state(params, cfg, B, CACHE, page_size=P,
                                n_pages=NPAGES, kv_dtype=kv_dtype)
    rows = np.full((B, PPS), NPAGES, np.int32)
    rows[:, :3] = np.arange(3 * B).reshape(B, 3) + 2
    TM.reset_paged_slots(cfg, state, {"layers": [[{}]]},
                         torch.ones(B, dtype=torch.bool, device="cuda"),
                         torch.from_numpy(rows).cuda(),
                         torch.zeros(B, dtype=torch.int32, device="cuda"))
    if kind == "ragged":
        step = SS.make_ragged_step(cfg, width=C + 1, flash_decode=flash)
    else:
        step = SS.make_paged_step(cfg, with_logits=kind == "decode",
                                  flash_decode=flash)
    inputs = [torch.from_numpy(a).cuda() for a in _pack_for(kind, seed=7)]
    step(params, state, *inputs)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(params, state, *inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
