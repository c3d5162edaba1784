"""The port's model against the JAX package's, on the qwen2-1.5b smoke
config in float32 (as tests/test_serve_api.py runs it): parameter layout,
the ragged serving step (logits and every state leaf over random mixed
packs, float32 and int8 pools, kernel route and gather route), slot
resets with an inherited prefix and copy-on-write page copies.  Both sides
start from the same weights and state through ``repro_torch.bridge``.
Tolerance atol = rtol = 1e-4 for logits and float leaves; integer leaves
(block tables, positions, fill counts, int8 values) must be equal."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_param_names_and_shapes_follow_the_jax_pytree(qwen):
    cfg, tcfg, jp, tp = qwen
    want = {k: tuple(v.shape) for k, v in _flat(jax.tree.map(np.asarray, jp)).items()}
    for params in (tp, TM.init_params(tcfg, device="cpu")):
        got = {k: tuple(v.shape) for k, v in params.named_parameters()}
        assert got == want
        assert params.final_norm["scale"].dtype == torch.float32
        assert params.stages[0][0].mixer_norm["scale"].dtype == torch.float32


def test_init_params_casts_matrices_once_and_keeps_norm_scales_f32():
    cfg = tget("qwen2-1.5b", smoke=True)  # bfloat16 activations
    p = TM.init_params(cfg, generator=torch.Generator().manual_seed(1),
                       device="cpu")
    blk = p.stages[0][0]
    assert blk.mixer["wq"].dtype == torch.bfloat16
    assert p.embed["tok_embed"].dtype == torch.bfloat16
    assert blk.ffn_norm["scale"].dtype == torch.float32
    # truncated normal on [-2, 2] scaled by fan_in^-1/2
    w = blk.mixer["wk"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-2


def _compare_states(jstate, tstate, tcfg):
    want = _flat(jax.tree.map(np.asarray, jstate))
    got = _flat(bridge.state_to_numpy(tstate, tcfg))
    assert got.keys() == want.keys()
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _reset(cfg, tcfg, js, ts, mask, rows, plen):
    js = JM.reset_paged_slots(cfg, js, js, jnp.asarray(mask), jnp.asarray(rows),
                              jnp.asarray(plen))
    tmpl = {"layers": [[{k: v.clone() for k, v in c.items()
                         if k in ("ptab", "kpos", "slen")} for c in ss]
                       for ss in ts["layers"]]}
    TM.reset_paged_slots(tcfg, ts, tmpl, torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    return js


def _random_pack(rng, cursor, T, B, vocab):
    """Each slot contributes a decode token or a short prefill chunk at its
    next positions; one invalid entry sits mid-pack and the tail is
    invalid.  logit_idx points at each slot's last token."""
    tokens = rng.randint(0, vocab, T).astype(np.int32)
    slot = np.zeros(T, np.int32)
    q_pos = np.zeros(T, np.int32)
    seq = np.zeros(T, np.int32)
    valid = np.zeros(T, bool)
    logit_idx = np.full(B, T, np.int32)
    n = 0
    for b in range(B):
        c = 1 if rng.rand() < 0.4 else rng.randint(2, 6)
        for i in range(c):
            slot[n], q_pos[n], seq[n], valid[n] = b, cursor[b], i, True
            n += 1
            cursor[b] += 1
        logit_idx[b] = n - 1
        if b == 0:
            n += 1  # an invalid entry between slots
    assert n < T
    return tokens, slot, q_pos, seq, valid, logit_idx


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ragged_step_matches_jax(qwen, kv_dtype, flash):
    """Logits and every state leaf after each of several random mixed
    packs.  Slot 2 maps a single page, so its later writes hit the sentinel
    page (dropped on both sides); mid-run slot 1 is re-admitted on slot 0's
    first page as an inherited 5-token prefix, and a page is copied
    copy-on-write."""
    cfg, tcfg, jp, tp = qwen
    B, cache_len, P, n_pages, T = 3, 64, 8, 30, 24
    pps = cache_len // P
    js = JM.init_paged_state(jp, cfg, B, cache_len, page_size=P,
                             n_pages=n_pages, kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(jax.tree.map(np.asarray, js), tcfg, "cpu")
    rows = np.full((B, pps), n_pages, np.int32)
    rows[0, :4] = [3, 17, 9, 22]
    rows[1, :4] = [5, 11, 0, 28]
    rows[2, :1] = [14]
    js = _reset(cfg, tcfg, js, ts, np.ones(B, bool), rows,
                np.zeros(B, np.int32))
    rng = np.random.RandomState(7)
    cursor = [0] * B
    for step in range(5):
        if step == 2:
            new = np.full((B, pps), n_pages, np.int32)
            new[1, :3] = [3, 26, 27]  # page 3 is slot 0's first page
            mask = np.asarray([False, True, False])
            js = _reset(cfg, tcfg, js, ts, mask, new,
                        np.asarray([0, 5, 0], np.int32))
            cursor[1] = 5
            src = np.asarray([17, n_pages, n_pages], np.int32)
            dst = np.asarray([26, n_pages, n_pages], np.int32)
            js = JM.copy_kv_pages(cfg, js, jnp.asarray(src), jnp.asarray(dst))
            TM.copy_kv_pages(tcfg, ts, src, dst)
            _compare_states(js, ts, tcfg)
        vecs = _random_pack(rng, cursor, T, B, cfg.vocab_size)
        jl, js = JM.ragged_step(jp, cfg, js, *(jnp.asarray(a) for a in vecs),
                                width=8, flash_decode=flash)
        tl, ts = TM.ragged_step(tp, tcfg, ts, *(torch.from_numpy(a) for a in vecs),
                                width=8, flash_decode=flash)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(js, ts, tcfg)
    assert cursor[2] > P  # slot 2 wrote past its only mapped page


def test_ragged_step_updates_state_in_place(qwen):
    cfg, tcfg, jp, tp = qwen
    ts = TM.init_paged_state(tp, tcfg, 2, 32, page_size=8, n_pages=8,
                             kv_dtype="int8")
    leaves = [t for ss in ts["layers"] for c in ss for t in c.values()]
    ptrs = [t.data_ptr() for t in leaves]
    rows = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    TM.reset_paged_slots(tcfg, ts, {"layers": [[{}]]}, torch.ones(2, dtype=torch.bool),
                         rows, torch.zeros(2, dtype=torch.int32))
    T = 6
    vecs = [torch.arange(T, dtype=torch.int32),
            torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.int32),
            torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32),
            torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32),
            torch.ones(T, dtype=torch.bool), torch.tensor([2, 5], dtype=torch.int32)]
    _, out = TM.ragged_step(tp, tcfg, ts, *vecs, width=4, flash_decode=True)
    assert out is ts
    assert [t.data_ptr() for t in leaves] == ptrs
    assert int(ts["layers"][0][0]["slen"][0, 1]) == 3
    assert bool((ts["layers"][0][0]["ks"] != 0).any())


def test_init_params_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(tget("qwen2-1.5b", smoke=True))
