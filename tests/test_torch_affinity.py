"""The port's rank-order model over NVLink domains (``core/affinity.py``)
and its production mesh (``launch.mesh.make_production_mesh``).

The expected values are worked out by hand below, from the model's two
costs: a ring step costs 1 inside an 8-GPU domain and 9 (NVLink's 450 GB/s
over the network's 50 GB/s) across domains.  The table keeps the JAX
package's keys.  The production mesh is built under a fake process group
of 256 and 512 ranks (``op_cost.fake_group``), in this one process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.core import affinity as A  # noqa: E402
from repro_torch.core import op_cost  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def test_domains_and_step_costs():
    assert [A.domain_of(r) for r in (0, 7, 8, 15, 16, 255)] == [0, 0, 1, 1, 2, 31]
    assert A.domain_of(5, gpus_per_domain=4) == 1
    assert A.CROSS_DOMAIN_COST == 9.0
    assert (A.step_cost(3, 3), A.step_cost(0, 7), A.step_cost(7, 8)) == (0.0, 1.0, 9.0)
    # a ring of 16 ranks 0..15: steps 0->1 .. 14->15 are 15 steps, of which
    # 7->8 crosses; the wrap 15->0 crosses too
    assert A.ring_steps(list(range(16))) == [1.0] * 7 + [9.0] + [1.0] * 7 + [9.0]
    assert A.ring_cost(list(range(16))) == 14 + 2 * 9


def test_pinned_16x16_model_rings_leave_the_domain():
    """Each 'model' ring (16 ranks, two domains) crosses domains twice in
    16 steps: mean (14 + 2 * 9) / 16 = 2.0, slowest step 9.  Each 'data'
    ring (ranks j, 16 + j, ...) crosses on every step: mean 9, slowest 9."""
    p = A.pinned_placement(16, 16)
    assert p.name == "pinned"
    assert np.array_equal(p.device_order, np.arange(256).reshape(16, 16))
    assert p.axis_ring_cost == {"model": (14 + 2 * 9) / 16, "data": 9.0}
    assert A.collective_slowdown(p, "model") == 9.0
    assert A.collective_slowdown(p, "data") == 9.0


def test_pinned_32x8_model_rings_stay_in_the_domain():
    """A 'model' group of 8 is one domain: every step costs 1."""
    p = A.pinned_placement(32, 8)
    assert p.axis_ring_cost["model"] == 1.0
    assert A.collective_slowdown(p, "model") == 1.0
    assert A.collective_slowdown(p, "data") == 9.0


def test_naive_order_is_worse_on_model():
    pin, naive = A.pinned_placement(), A.naive_placement()
    want = np.random.RandomState(0).permutation(256).reshape(16, 16)
    assert np.array_equal(naive.device_order, want)
    assert naive.axis_ring_cost["model"] > pin.axis_ring_cost["model"]
    assert A.naive_placement(32, 8).axis_ring_cost["model"] > 1.0
    assert A.collective_slowdown(A.naive_placement(32, 8), "model") == 9.0
    # every naive ring mean is a mix of 1s and 9s over the ring's steps
    cost = naive.axis_ring_cost["model"]
    assert 1.0 < cost <= 9.0 and (cost * 16 * 16) == round(cost * 16 * 16)


def test_placement_table_has_jax_keys():
    jax_affinity = pytest.importorskip("repro.core.affinity")
    rows, want = A.placement_table(), jax_affinity.placement_table()
    assert [sorted(r) for r in rows] == [sorted(r) for r in want]
    assert [r["placement"] for r in rows] == [r["placement"] for r in want]
    pinned = rows[0]
    assert pinned["model_ring_hops_per_step"] == 2.0
    assert pinned["model_collective_slowdown"] == 9.0
    assert pinned["data_ring_hops_per_step"] == 9.0


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_production_mesh_under_a_fake_group(multi_pod):
    n = 512 if multi_pod else 256
    with op_cost.fake_group(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        unpinned = make_production_mesh(multi_pod=multi_pod, pinned=False,
                                        device="cpu")
        assert mesh.device_type == "cpu"
        if multi_pod:
            assert tuple(mesh.shape) == (2, 16, 16)
            assert mesh.mesh_dim_names == ("pod", "data", "model")
        else:
            assert tuple(mesh.shape) == (16, 16)
            assert mesh.mesh_dim_names == ("data", "model")
        order = A.pinned_placement(16, 16).device_order
        pods = [mesh.mesh] if not multi_pod else list(mesh.mesh)
        for p, pod in enumerate(pods):
            assert np.array_equal(pod.numpy(), order + 256 * p)
        assert np.array_equal(unpinned.mesh.numpy().ravel(), np.arange(n))
        # rank 0's 'model' group is its pinned row
        assert torch.distributed.get_process_group_ranks(
            mesh.get_group("model")) == list(order[0])


@pytest.mark.parametrize("world", [64, 300])
def test_production_mesh_needs_256_or_512_ranks(world):
    with op_cost.fake_group(world):
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")
    assert not torch.distributed.is_initialized()
