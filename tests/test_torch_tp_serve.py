"""Tensor-parallel serving of the PyTorch port (``ServeEngine(mesh=)``) on
gloo rank processes, against the JAX package's 1-device engine.

The JAX package's invariance suite (tests/test_serve_tp.py) runs one
seeded traffic — qwen1.5-4b smoke (4 KV heads), int8 pools, a shared
family prefix, a mid-flight cancel — at 1, 2 and 4 devices and asserts
token-identical transcripts.  Here the reference is JAX's 1-device engine
on that traffic, with the same weights (bridged through numpy, float32
activations), and N port ranks (``launch.ranks.run_ranks``; each rank's
pools hold 4/N heads, and the attention output is all-gathered before the
out-projection) must give its transcript token for token on EVERY rank,
with JAX's in-process invariants on each: one trace of the ragged step,
``_ref`` all zero, ``reclaimable_pages == n_pages``, ``kv_shards`` and
``n_devices`` N, ``kv_pool_bytes_per_device * kv_shards ==
kv_pool_bytes``, and every other stat equal to JAX's.  Routes: the gather
route at 1, 2 and 4 ranks; the kernel route (``flash_decode=True``, the
plain versions of the kernels on the CPU) at 2 and 4, against JAX's
``flash_decode=True`` engine.  The ``tp_`` kernel wrappers on the CPU
take q with every head of the layer (JAX's call) or with the rank's
(the attention layer's) and give the same output.

``gpu`` tests (they decide inside their body whether there is a card):
kernels 1 and 2 on each rank's share of the pools at 2 and 4 ranks
(``parallel.sharding.MeshView``), concatenated on heads, equal the
whole-pool kernel bitwise; and the engine on 1 NCCL rank and, on a
machine with 2 or 4 cards, on that many (qwen1.5-4b at full width, 4
layers, the kernel route, captured: past 1 rank, the all-gather inside
each step's graph) gives the transcripts of the engine without a mesh on
every rank.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_tp_ranks as R  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401

ARCH = "qwen1.5-4b"


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine

    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    refs = {}

    def ref(flash: bool):
        if flash not in refs:
            eng = ServeEngine(params, cfg, **R.TP_KW, flash_decode=flash)
            refs[flash] = (R.drive(eng, cfg.vocab_size), eng.stats)
        return refs[flash]

    return types.SimpleNamespace(
        cfg=cfg, ref=ref, tree=jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_gather_route_matches_jax(jx, n):
    R.check_tp_case(jx.ref(False), ARCH, jx.tree, n, {}, kv_heads=4)


@pytest.mark.parametrize("n", [2, 4])
def test_kernel_route_matches_jax(jx, n):
    R.check_tp_case(jx.ref(True), ARCH, jx.tree, n, {"flash_decode": True},
                    kv_heads=4)


@pytest.mark.parametrize("kind", ["decode", "ragged"])
def test_tp_wrappers_take_every_head_or_the_ranks(kind):
    """The ``tp_`` wrappers on the CPU (the kernels' plain versions), float32:
    under rank r of 2 a q with every head of the layer (JAX's call) and the
    rank's contiguous slice of it (the attention layer's call) give the
    same output, the whole-pool call's heads of that rank (rtol = atol =
    1e-6: the plain versions batch the heads); without a mesh the wrapper
    is the whole-pool call; a q whose heads do not map onto the pools'
    raises."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import MeshView, make_serve_rules, use_mesh
    from repro_torch.serve import decode_attention as DA

    g = torch.Generator().manual_seed(0)
    B, pps, P, kvH, G, hd, T = 3, 4, 8, 4, 2, 16, 12
    ptab = torch.randperm(B * pps, generator=g).reshape(B, pps).int()
    kp = torch.randn(B * pps, P, kvH, hd, generator=g)
    vp = torch.randn(B * pps, P, kvH, hd, generator=g)
    if kind == "decode":
        q = torch.randn(B, kvH, G, hd, generator=g)
        index = (ptab, torch.tensor([30, 5, 17], dtype=torch.int32))
        tp_call, whole_call = DA.tp_paged_flash_decode, ops.paged_flash_decode
    else:
        q = torch.randn(T, kvH, G, hd, generator=g)
        slot = torch.arange(T, dtype=torch.int32) % B
        index = (ptab, slot, (torch.arange(T) + 1).int())
        tp_call, whole_call = DA.tp_ragged_paged_flash, ops.ragged_paged_flash
    whole = whole_call(q, kp, vp, *index)
    assert torch.equal(tp_call(q, kp, vp, *index), whole)
    for r in range(2):
        hs = slice(2 * r, 2 * r + 2)
        own = [t[:, :, hs].contiguous() for t in (kp, vp)]
        view = MeshView((2,), ("model",), (r,))
        with use_mesh(view, make_serve_rules(view)):
            got = tp_call(q, *own, *index)
            assert torch.equal(tp_call(q[:, hs].contiguous(), *own, *index),
                               got)
            with pytest.raises(ValueError, match="do not map onto"):
                tp_call(q[:, :3].contiguous(), *own, *index)
        torch.testing.assert_close(got, whole[:, hs], rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_kernel_rank_shares_are_the_whole_on_the_card():
    """Kernels 1 and 2 on each rank's own contiguous pools (bf16 and int8)
    through the ``tp_`` wrappers under a ``MeshView`` of rank r of N:
    concatenated on heads, the ranks' outputs equal the whole-pool kernel
    bitwise (both kernels choose their key splits from the context length
    alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import MeshView, make_serve_rules, use_mesh
    from repro_torch.serve import decode_attention as DA

    g = torch.Generator(device="cuda").manual_seed(0)
    B, pps, P, kvH, G, hd, T = 4, 8, 16, 8, 2, 128, 48
    n_pages = B * pps
    ptab = torch.randperm(n_pages, device="cuda", generator=g).reshape(
        B, pps).int()
    lens = torch.tensor([100, 37, 128, 5], device="cuda", dtype=torch.int32)
    slot = torch.arange(T, device="cuda", dtype=torch.int32) % B
    tlens = torch.clamp(lens[slot.long()] - torch.arange(T, device="cuda") // B,
                        min=1).int()
    for kv_dtype in ("bfloat16", "int8"):
        kp = torch.randn(n_pages, P, kvH, hd, device="cuda", generator=g)
        vp = torch.randn(n_pages, P, kvH, hd, device="cuda", generator=g)
        if kv_dtype == "int8":
            ks, vs = kp.abs().amax(-1) / 127, vp.abs().amax(-1) / 127
            kp = torch.round(kp / ks[..., None]).to(torch.int8)
            vp = torch.round(vp / vs[..., None]).to(torch.int8)
        else:
            ks = vs = None
            kp, vp = kp.bfloat16(), vp.bfloat16()
        qd = torch.randn(B, kvH, G, hd, device="cuda", generator=g).bfloat16()
        qr = torch.randn(T, kvH, G, hd, device="cuda", generator=g).bfloat16()
        whole_d = ops.paged_flash_decode(qd, kp, vp, ptab, lens, ks=ks, vs=vs)
        whole_r = ops.ragged_paged_flash(qr, kp, vp, ptab, slot, tlens,
                                         ks=ks, vs=vs)
        for n in (2, 4):
            parts_d, parts_r = [], []
            for r in range(n):
                view = MeshView((n,), ("model",), (r,))
                hs = slice(r * kvH // n, (r + 1) * kvH // n)
                own = [t[..., hs, :].contiguous() for t in (kp, vp)]
                sc = ([t[..., hs].contiguous() for t in (ks, vs)]
                      if ks is not None else [None, None])
                with use_mesh(view, make_serve_rules(view)):
                    parts_d.append(DA.tp_paged_flash_decode(
                        qd, *own, ptab, lens, ks=sc[0], vs=sc[1]))
                    parts_r.append(DA.tp_ragged_paged_flash(
                        qr, *own, ptab, slot, tlens, ks=sc[0], vs=sc[1]))
            assert torch.equal(torch.cat(parts_d, 1), whole_d), (kv_dtype, n)
            assert torch.equal(torch.cat(parts_r, 1), whole_r), (kv_dtype, n)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 4])
def test_engine_across_cards(n):
    """The engine on ``n`` NCCL ranks, one card each, gives the engine
    without a mesh its transcripts on every rank (at 1 rank: the 1-rank
    NCCL group, where no collective runs)."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    from repro_torch.launch.ranks import run_ranks

    args = (ARCH, n, False, 4)
    [ref] = run_ranks("_torch_tp_ranks:cards_rank", 1, (ARCH, 0, False, 4),
                      device="cuda")
    for res in run_ranks("_torch_tp_ranks:cards_rank", n, args,
                         device="cuda"):
        for kvd, (transcript, st) in res.items():
            want, ref_st = ref[kvd]
            assert transcript == want, (kvd, transcript, want)
            assert st["kv_shards"] == st["n_devices"] == n, st
            assert st["graph_captures"] == ref_st["graph_captures"] > 0, st
            assert st["kernel_launches"] == ref_st["kernel_launches"] > 0, st
            assert st["kv_pool_bytes_per_device"] * n == st["kv_pool_bytes"]
