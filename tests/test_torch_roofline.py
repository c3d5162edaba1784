"""The port's cost model (``repro_torch.core``: roofline, memory model,
``sweep.score``) against the JAX package's, on the CPU.

Every comparison prices the same card on both sides: the JAX ``HwSpec`` is
built from the port's ``dataclasses.asdict(H100)``.  The two packages run
the same Python float arithmetic in the same order, so every output is
compared with ``==``:

- ``decode_bound`` and ``mixed_bound`` for every registry config, smoke and
  full, over a grid of batch/token counts, contexts, page sizes (None, 8,
  16), pool dtypes (None, float32, bfloat16, int8) and device counts (1, 2,
  4), and ``mixed_bound``'s promotion, swap and speculation terms;
- ``roofline_terms`` and ``format_row`` on synthetic dry-run rows over
  ``all_cells()`` x meshes 1, 16x16, 2x16x16;
- ``memory_model.estimate``, ``analytic_traffic`` and ``fits_hbm`` over the
  same cells at 1 and 8 microbatches, float32 and int8 moments;
- ``sweep.score`` on synthetic cost rows;
- the ``ValueError`` paths, and the KV tables' single source.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro_torch.configs import ARCH_NAMES, SHAPES_BY_NAME, all_cells
from repro_torch.configs import get_config as tget
from repro_torch.core import memory_model as tmm
from repro_torch.core import roofline as tr
from repro_torch.core import sweep as tsweep
from repro_torch.serve import pool as tpool

MESHES = ("1", "16x16", "2x16x16")
CONFIGS = [(a, s) for a in ARCH_NAMES for s in (True, False)]
CONFIG_IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CONFIGS]
KV_DTYPES = (None, "float32", "bfloat16", "int8")


@pytest.fixture(scope="module")
def J():
    """The JAX package's cost model and configs (imported lazily)."""
    pytest.importorskip("jax")
    from repro.configs import SHAPES_BY_NAME, get_config
    from repro.core import memory_model, roofline, sweep

    return dict(get_config=get_config, shapes=SHAPES_BY_NAME,
                roofline=roofline,
                memory_model=memory_model, sweep=sweep,
                hw=roofline.HwSpec(**dataclasses.asdict(tr.H100)))


def mesh_shape(mesh: str) -> dict:
    """A dry-run mesh string as roofline_terms reads it."""
    dims = [int(x) for x in mesh.split("x")]
    return dict(zip(("pod", "data", "model")[-len(dims):], dims))


def dryrun_rows(mesh: str):
    """Synthetic dry-run rows (seeded) for every cell at ``mesh``."""
    rng = np.random.RandomState(sum(map(ord, mesh)))
    n_dev = int(np.prod(list(mesh_shape(mesh).values())))
    for arch, shape in all_cells():
        yield {"arch": arch, "shape": shape, "mesh": mesh,
               "n_devices": n_dev,
               "flops_per_device": float(rng.uniform(1e9, 1e17)),
               "bytes_per_device": float(rng.uniform(1e6, 1e13)),
               "collective_bytes_per_device": float(
                   rng.choice([0.0, rng.uniform(1e3, 1e12)]))}


def test_h100_spec_keeps_the_jax_fields(J):
    port = [f.name for f in dataclasses.fields(tr.HwSpec)]
    assert port == [f.name for f in dataclasses.fields(J["roofline"].HwSpec)]
    assert dataclasses.asdict(tr.H100) == {
        "name": "h100-sxm5-80gb", "peak_flops": 989e12, "hbm_bw": 3.35e12,
        "ici_bw": 450e9, "h2d_bw": 64e9}
    assert not hasattr(tr, "V5E")
    # either package's spec is built from the other's fields
    assert dataclasses.asdict(tr.HwSpec(**dataclasses.asdict(J["hw"]))) \
        == dataclasses.asdict(tr.H100)


def test_kv_tables_have_one_source(J):
    assert tpool.KV_ITEMSIZE is tr.KV_ITEMSIZE
    assert tpool.KV_SCALE_BYTES is tr.KV_SCALE_BYTES
    assert tr.KV_ITEMSIZE == J["roofline"].KV_ITEMSIZE
    assert tr.KV_SCALE_BYTES == J["roofline"].KV_SCALE_BYTES
    for kv, hd, act in itertools.product(KV_DTYPES, (16, 80, 128, 256), (2, 4)):
        assert (tr._kv_elem_bytes(kv, hd, act)
                == J["roofline"]._kv_elem_bytes(kv, hd, act))


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=CONFIG_IDS)
def test_decode_bound_matches_jax(J, arch, smoke):
    cfg, jcfg = tget(arch, smoke=smoke), J["get_config"](arch, smoke=smoke)
    for batch, ctx, page, kv, ndev in itertools.product(
            (1, 8, 64), (1, 100, 2048, 32768), (None, 8, 16), KV_DTYPES,
            (1, 2, 4)):
        kw = dict(page_size=page, kv_dtype=kv, n_devices=ndev)
        got = tr.decode_bound(cfg, batch, ctx, **kw)
        assert got == J["roofline"].decode_bound(jcfg, batch, ctx,
                                                 hw=J["hw"], **kw), \
            (batch, ctx, kw)
    # the default card is the H100
    assert tr.decode_bound(cfg, 8, 2048) == J["roofline"].decode_bound(
        jcfg, 8, 2048, hw=J["hw"])


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=CONFIG_IDS)
def test_mixed_bound_matches_jax(J, arch, smoke):
    cfg, jcfg = tget(arch, smoke=smoke), J["get_config"](arch, smoke=smoke)
    jmb = J["roofline"].mixed_bound
    for nd, npf, ctx, page, kv, ndev in itertools.product(
            (0, 1, 8), (0, 7, 120), (1, 100, 2048), (None, 8, 16), KV_DTYPES,
            (1, 2, 4)):
        kw = dict(page_size=page, kv_dtype=kv, n_devices=ndev)
        assert tr.mixed_bound(cfg, nd, npf, ctx, **kw) == jmb(
            jcfg, nd, npf, ctx, hw=J["hw"], **kw), (nd, npf, ctx, kw)
    # the tier, swap and speculation terms
    for nd, npf, ctx, page, kv, ndev, promo, swap, draft, acc in (
            itertools.product((1, 8), (0, 120), (256, 4096), (None, 16),
                              (None, "int8"), (1, 4), (0.0, 2.5),
                              (0.0, 3.0), (0.0, 4.0), (0.0, 0.6))):
        kw = dict(page_size=page, kv_dtype=kv, n_devices=ndev,
                  promoted_pages=promo, swapped_pages=swap,
                  draft_tokens=draft, accept_rate=acc)
        assert tr.mixed_bound(cfg, nd, npf, ctx, **kw) == jmb(
            jcfg, nd, npf, ctx, hw=J["hw"], **kw), (nd, npf, ctx, kw)


@pytest.mark.parametrize("kw", [dict(accept_rate=-0.1), dict(accept_rate=1.5),
                                dict(draft_tokens=-1)],
                         ids=["accept-low", "accept-high", "draft-negative"])
def test_mixed_bound_value_errors_match(J, kw):
    cfg = tget("qwen2-1.5b", smoke=True)
    jcfg = J["get_config"]("qwen2-1.5b", smoke=True)
    with pytest.raises(ValueError) as port:
        tr.mixed_bound(cfg, 8, 0, 256, **kw)
    with pytest.raises(ValueError) as ref:
        J["roofline"].mixed_bound(jcfg, 8, 0, 256, hw=J["hw"], **kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("mesh", MESHES)
def test_roofline_terms_and_rows_match_jax(J, mesh):
    jr = J["roofline"]
    n = 0
    for row in dryrun_rows(mesh):
        for mb in (None, 1, 8):
            got = tr.roofline_terms(row, microbatches=mb)
            assert got == jr.roofline_terms(row, hw=J["hw"],
                                            microbatches=mb), (row, mb)
            assert tr.format_row(row, got) == jr.format_row(row, got)
            n += 1
        # a config passed in, as the autotuner's candidates do
        cfg = tget(row["arch"]).replace(remat="dots")
        jcfg = J["get_config"](row["arch"]).replace(remat="dots")
        assert tr.roofline_terms(row, cfg=cfg) == jr.roofline_terms(
            row, hw=J["hw"], cfg=jcfg)
    assert n == 3 * len(list(all_cells()))


@pytest.mark.parametrize("mesh", MESHES)
def test_memory_model_matches_jax(J, mesh):
    jmm = J["memory_model"]
    ms = mesh_shape(mesh)
    for arch, shape_name in all_cells():
        cfg, jcfg = tget(arch), J["get_config"](arch)
        shape = SHAPES_BY_NAME[shape_name]
        jshape = J["shapes"][shape_name]
        for mb, opt_int8 in itertools.product((1, 8), (None, False, True)):
            est = tmm.estimate(cfg, shape, ms, mb, opt_int8)
            assert est == jmm.estimate(jcfg, jshape, ms, mb, opt_int8), \
                (arch, shape_name, mb, opt_int8)
            for hbm in (16 * 2**30, 80 * 2**30):
                assert (tmm.fits_hbm(est["total"], hbm)
                        == jmm.fits_hbm(est["total"], hbm))
        for mb in (1, 8):
            assert (tmm.analytic_traffic(cfg, shape, ms, mb)
                    == jmm.analytic_traffic(jcfg, jshape, ms, mb))


def test_fits_hbm_defaults_to_one_h100():
    assert tmm.fits_hbm(0.9 * 80 * 2**30)
    assert not tmm.fits_hbm(0.9 * 80 * 2**30 + 1)
    assert tmm._dtype_size("bfloat16") == 2 and tmm._dtype_size("float32") == 4


def test_sweep_score_matches_jax(J):
    rng = np.random.RandomState(3)
    for nproc, nthread in tsweep.factorizations(256):
        for coll in (0.0, float(rng.uniform(1e6, 1e12))):
            row = {"nproc": nproc, "nthread": nthread, "N": 4096,
                   "flops_per_device": float(rng.uniform(1e9, 1e15)),
                   "bytes_per_device": float(rng.uniform(1e6, 1e12)),
                   "collective_bytes_per_device": coll,
                   "model_flops": float(rng.uniform(1e12, 1e17)),
                   "n_devices": nproc * nthread}
            got = tsweep.score(row)
            assert got == J["sweep"].score(row, hw=J["hw"]), row
            assert 0 < got["peak_fraction"] <= 1.0
