"""Rank-side functions of the tensor-parallel tests of the PyTorch port
(tests/test_torch_tp_*.py, test_torch_sp_decode.py).

``launch.ranks.run_ranks`` runs these functions in fresh rank processes,
which must not import JAX: this module imports torch, numpy and the port
only.  The parents compute the JAX references and pass numpy in.

``drive`` is the traffic of the JAX package's tensor-parallel invariance
suite (tests/test_serve_tp.py): staggered submits, a shared 16-token family
prefix, a mid-flight cancel; it runs on either package's engine, so the
parent drives JAX's 1-device engine with it and every rank the port's.
"""
import numpy as np
import torch

# the JAX suite's engine settings (tests/test_serve_tp.py)
TP_KW = dict(batch_size=2, cache_len=64, page_size=8, prefill_chunk=8,
             token_budget=16, kv_dtype="int8")


def drive(eng, vocab: int, tier_wave: bool = False):
    """The JAX suite's traffic through ``eng``; returns its canonical
    transcript, sorted ((uid, tokens), ...).  ``tier_wave`` adds a second
    wave for an engine with a host tier and a tight pool: fillers that
    demote the cached family pages to host RAM, then a family request that
    promotes them back."""
    rng = np.random.default_rng(7)
    [family] = [rng.integers(1, vocab, size=16)]
    handles = []
    for i in range(6):
        if i % 2:
            prompt = np.concatenate([family, rng.integers(1, vocab,
                                                          size=1 + i)])
        else:
            prompt = rng.integers(1, vocab, size=int(rng.integers(3, 24)))
        handles.append(eng.submit(prompt, max_tokens=4 + i % 5))
        eng.tick()
    handles[2].cancel()
    res = eng.run()
    if tier_wave:
        for _ in range(4):
            eng.submit(rng.integers(1, vocab, size=24), max_tokens=4)
        res.update(eng.run())
        eng.submit(np.concatenate([family, rng.integers(1, vocab, size=5)]),
                   max_tokens=4)
        res.update(eng.run())
    return sorted((int(k), tuple(int(t) for t in v)) for k, v in res.items())


def _heads(eng):
    """The KV-head count of every pool tensor and windowed buffer of the
    engine's state."""
    return [c[k].shape[-1] if k in ("ks", "vs") else c[k].shape[-2]
            for ss in eng._state["layers"] for c in ss
            for k in ("kp", "vp", "ks", "vs", "k", "v") if k in c]


def serve_rank(arch: str, tree, n: int, engine_kw: dict,
               tier_wave: bool = False):
    """One rank of the port's engine on an ``n``-rank ("model",) mesh (no
    mesh at ``n == 0``), the JAX parameters ``tree`` bridged through
    numpy, the suite's traffic; asserts the JAX suite's in-process
    invariants and returns (transcript, stats, pool head counts)."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    kw = {**TP_KW, **engine_kw}
    if n:
        from repro_torch.launch.mesh import make_mesh

        kw["mesh"] = make_mesh((n,), ("model",), device="cpu")
    eng = ServeEngine(params, cfg, device="cpu", **kw)
    transcript = drive(eng, cfg.vocab_size, tier_wave)
    st = eng.stats
    assert st["traces"] == (1 if eng.ragged else 0), st["traces"]
    assert st["graph_captures"] == 0  # eager on the CPU
    assert (eng._ref == 0).all()
    assert eng.reclaimable_pages == eng.n_pages
    assert st["n_devices"] == max(n, 1)
    assert st["kv_shards"] == max(n, 1)
    return transcript, st, _heads(eng)


def sp_decode_rank(case: dict, rules_kw: dict, shape, axes):
    """``sp_flash_decode`` on this rank's shard of ``case``'s q, k, v and
    k_pos (numpy, the whole arrays), under ``make_rules(mesh,
    **rules_kw)``; returns the rank's output and its batch slice."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import (local_slices, logical_spec,
                                               make_rules, sanitize_spec,
                                               use_mesh)
    from repro_torch.serve.decode_attention import sp_flash_decode
    from repro_torch.serve.serve_step import STATE_AXES

    mesh = make_mesh(shape, axes, device="cpu")
    rules = make_rules(mesh, **rules_kw)
    q, k, v, k_pos = (torch.from_numpy(case[n])
                      for n in ("q", "k", "v", "k_pos"))

    def local(t, names):
        spec = sanitize_spec(logical_spec(names, rules), t.shape, mesh)
        sl = local_slices(spec, t.shape, mesh)
        return t[sl].contiguous(), sl

    kv_axes = STATE_AXES["k"]
    ql, qsl = local(q, (kv_axes[0], None, None, None, None))
    kl, _ = local(k, kv_axes)
    vl, _ = local(v, kv_axes)
    pl, _ = local(k_pos, STATE_AXES["k_pos"])
    with use_mesh(mesh, rules):
        out = sp_flash_decode(ql, kl, vl, pl, torch.tensor(case["pos"]),
                              window=case["window"])
    return out.numpy(), (qsl[0].start, qsl[0].stop)


def lockstep_rank(arch: str, tree, n: int, tokens, cache_len: int):
    """Four lock-step decode tokens of ``arch`` with ``sp_decode=True``:
    on an ``n``-rank ("model",) sequence mesh under ``make_rules(decode=
    True)``, each rank holding its ``cache_len/n`` entries of every cache,
    or (``n == 0``) without a mesh.  Returns the logits of each step."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = bridge.params_from_numpy(tree, cfg, "cpu")
    state = M.init_decode_state(params, cfg, tokens.shape[0], cache_len)
    ctx = None
    if n:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.sharding import make_rules, use_mesh
        from repro_torch.serve.serve_step import local_state

        mesh = make_mesh((n,), ("model",), device="cpu")
        rules = make_rules(mesh, decode=True)
        state = local_state(state, mesh, rules)
        ctx = use_mesh(mesh, rules)
    out = []
    if ctx is not None:
        ctx.__enter__()
    try:
        for t in range(tokens.shape[1]):
            logits, state = M.decode_step(
                params, cfg, state, torch.from_numpy(tokens[:, t:t + 1]),
                sp_decode=True)
            out.append(logits.numpy())
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return np.stack(out)


def mesh_rank(shape, axes) -> dict:
    """``make_mesh`` over the launcher's group, then a gather over 'model'
    and a sum over every axis."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import axis_group, axis_sizes

    mesh = make_mesh(shape, axes, device="cpu")
    me = torch.tensor([float(dist.get_rank())])
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "coord": list(mesh.get_coordinate()), "sizes": axis_sizes(mesh)}
    if "model" in axes:
        got = torch.empty(axis_sizes(mesh)["model"])
        dist.all_gather_into_tensor(got, me, group=axis_group(mesh, "model"))
        out["model_gather"] = [int(x) for x in got]
    total = me.clone()
    dist.all_reduce(total, group=axis_group(mesh, tuple(axes)))
    out["both_sum"] = int(total)
    return out


def fail_on_rank(bad: int) -> None:
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} says no")


def check_tp_case(jax_ref, arch: str, tree, n: int, engine_kw: dict,
                  kv_heads: int, tier_wave: bool = False,
                  timeout: float = 300.0):
    """Run ``serve_rank`` on ``n`` ranks and hold every rank to the JAX
    1-device engine's run ``jax_ref`` = (transcript, stats): the same
    transcript, every stat of JAX's but the three that count shards equal,
    those three as JAX computes them at ``n`` devices, and pools of
    ``kv_heads/n`` heads where ``n`` divides ``kv_heads`` (whole pools
    otherwise)."""
    from repro_torch.launch.ranks import run_ranks

    want, jstats = jax_ref
    ranks = run_ranks("_torch_tp_ranks:serve_rank", n,
                      (arch, tree, n, engine_kw, tier_wave), device="cpu",
                      timeout=timeout)
    split = kv_heads % n == 0
    tp_keys = ("kv_shards", "n_devices", "kv_pool_bytes_per_device")
    for r, (transcript, st, heads) in enumerate(ranks):
        assert transcript == want, (r, transcript, want)
        for key, val in jstats.items():
            if key not in tp_keys:
                assert st[key] == val, (r, key, st[key], val)
        per_rank = st["kv_pool_bytes_per_device"]
        if split:
            assert per_rank * st["kv_shards"] == st["kv_pool_bytes"]
        else:
            assert per_rank == st["kv_pool_bytes"]
        assert heads and set(heads) == {kv_heads // n if split else kv_heads}
    return ranks


def contract_rank(arch: str, n: int, ragged: bool) -> list:
    """``contracts.engine_programs`` and ``prove_program`` over a served
    engine on an ``n``-rank ("model",) mesh (seed-0 weights, int8 pools,
    the ragged engine with speculation and the host tier, or the two-phase
    one): returns each program's (name, findings, record); pool pointers
    must be kept across the proof."""
    from repro_torch.analysis import contracts as C
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    mesh = make_mesh((n,), ("model",), device="cpu")
    eng = ServeEngine(params, cfg, **TP_KW, ragged=ragged,
                      spec_k=2 if ragged else 0, host_pages=4 if ragged else 0,
                      mesh=mesh, device="cpu")
    rng = np.random.RandomState(0)
    for length in (12, 5):
        eng.submit(rng.randint(0, cfg.vocab_size, length), max_tokens=16)
    for _ in range(3):
        eng.tick()
    ptrs = C.pool_data_ptrs(eng._state)
    out = []
    for prog in C.engine_programs(eng):
        findings, rec = C.prove_program(prog, eng._state)
        out.append((prog.name, [str(f) for f in findings], rec))
    C.assert_in_place(ptrs, eng._state)
    return out


def cards_rank(arch: str, n: int, smoke: bool, layers: int) -> dict:
    """One rank of the engine on an ``n``-rank ("model",) mesh of its
    device (no mesh at ``n == 0``): ``arch`` (its smoke config, or its full
    width cut to ``layers`` layers) from seed-0 weights, the kernel route
    (``flash_decode=True``), bf16 and int8 pools, captured on a card, the
    suite's traffic at page 16.  Returns {kv_dtype: (transcript, stats)}."""
    from repro_torch.configs import Stage, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cfg = get_config(arch, smoke=smoke)
    if not smoke:
        cfg = cfg.replace(stages=(Stage(cfg.stages[0].pattern, layers),))
    params = M.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                           device=dev)
    mesh = make_mesh((n,), ("model",), device=dev.type) if n else None
    out = {}
    for kvd in ("bfloat16", "int8"):
        eng = ServeEngine(params, cfg, **{**TP_KW, "page_size": 16,
                                          "kv_dtype": kvd},
                          flash_decode=True, mesh=mesh, device=dev)
        transcript = drive(eng, cfg.vocab_size)
        keys = ("kv_shards", "n_devices", "graph_captures", "kernel_launches",
                "kv_pool_bytes", "kv_pool_bytes_per_device", "traces")
        out[kvd] = (transcript, {k: eng.stats[k] for k in keys})
        assert (eng._ref == 0).all() and eng.reclaimable_pages == eng.n_pages
    return out
