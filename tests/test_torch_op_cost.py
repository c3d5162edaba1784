"""The port's operation counter (``core/op_cost.py``), the counterpart of
the JAX package's HLO walker (``core/hlo_cost.py``).

- A loop of 11 steps of (4, 32) @ (32, 32): the counted FLOPs equal JAX's
  ``analyze`` of the same program (tests/test_core.py's trip-count case).
- Views count nothing, a matmul-class op 2 |result| K, a written tensor its
  bytes; the peak is the high-water mark of live storages.
- Each collective's result bytes (JAX's convention) on 2 and 4 gloo ranks
  and under a fake group of 256 ranks.
- A kernel's registered cost is added where its wrapper launches; a kernel
  with none raises.
- ``fake_group`` destroys its group on exit, also after an exception, and
  refuses to start over a running group.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.core import op_cost  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402


def _loop(x, w):
    c = x
    for _ in range(11):
        c = torch.tanh(c @ w)
    return c.sum()


def test_loop_flops_equal_jax_walker():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.hlo_cost import analyze

    def f(x):
        def body(c, _):
            return jnp.tanh(c @ jnp.ones((32, 32))), None
        c, _ = jax.lax.scan(body, x, None, length=11)
        return c.sum()

    compiled = jax.jit(f).lower(
        jax.ShapeDtypeStruct((4, 32), jnp.float32)).compile()
    want = analyze(compiled.as_text())["flops"]
    _, got = op_cost.count(_loop, torch.ones(4, 32), torch.ones(32, 32))
    assert got["flops"] == want == 11 * 2 * 4 * 32 * 32


def test_views_matmuls_traffic_and_peak():
    a = torch.ones(8, 16)  # 512 bytes
    b = torch.ones(16, 4)  # 256 bytes

    def prog(a, b):
        t = a.t()[:, :4].unsqueeze(0)  # views only
        c = a @ b  # (8, 4): 128 bytes, 2 * 32 * 16 FLOPs
        d = torch.bmm(c[None], torch.ones(1, 4, 2))  # ones: 32 bytes
        e = torch.empty(100)  # allocated, not written
        e.zero_()  # written in place: 400 bytes
        return t, d, e

    _, cost = op_cost.count(prog, a, b)
    assert cost["flops"] == 2 * 8 * 4 * 16 + 2 * 8 * 2 * 4
    # c 128, ones 32, d 64, e 400
    assert cost["traffic_bytes"] == 128 + 32 + 64 + 400
    assert cost["collective_bytes"] == 0
    # the peak comes with e: a, b, c, d and e live (the ones died with
    # the product that read them)
    assert cost["peak_bytes"] == 512 + 256 + 128 + 64 + 400

    def temporaries(a):
        for _ in range(3):
            a = a * 2  # each product replaces the last: two live at once
        return a

    _, cost = op_cost.count(temporaries, torch.ones(1024))
    assert cost["traffic_bytes"] == 3 * 4096
    assert cost["peak_bytes"] == 3 * 4096  # the argument and two products


def test_fake_tensors_count_a_card_program():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty(2, 4096, 1024, dtype=torch.bfloat16, device="cuda")
        b = torch.empty(2, 1024, 512, dtype=torch.bfloat16, device="cuda")
        c, cost = op_cost.count(
            lambda a, b: torch.bmm(a, b, out_dtype=torch.float32), a, b)
    assert c.dtype == torch.float32 and c.device.type == "cuda"
    assert cost["flops"] == 2.0 * 2 * 4096 * 512 * 1024
    assert cost["traffic_bytes"] == 2 * 4096 * 512 * 4
    assert cost["peak_bytes"] == (a.numel() + b.numel()) * 2 + c.numel() * 4


def _expected(n: int) -> dict:
    return {"all_reduce": ("all-reduce", 3 * 5 * 4),
            "all_gather": ("all-gather", 2 * n * 4 * 4),
            "reduce_scatter": ("reduce-scatter", 2 * 4 * 4),
            "all_to_all": ("all-to-all", 2 * n * 3 * 4),
            "functional_all_reduce": ("all-reduce", 6 * 2)}


def _check_collectives(got: dict, n: int) -> None:
    for name, (kind, nbytes) in _expected(n).items():
        cost = got[name]
        assert cost["collective_bytes"] == nbytes, (name, cost)
        assert cost[f"coll_{kind}"] == nbytes, (name, cost)
        assert cost["flops"] == 0


@pytest.mark.parametrize("n", [2, 4])
def test_collective_result_bytes_on_gloo_ranks(n):
    ranks = run_ranks("_torch_sweep_ranks:collectives", n, device="cpu",
                      timeout=300)
    for got in ranks:
        _check_collectives(got, n)


def test_collective_result_bytes_under_a_fake_group():
    import _torch_sweep_ranks

    with op_cost.fake_group(256):
        got = _torch_sweep_ranks.collectives()
    _check_collectives(got, 256)
    assert not dist.is_initialized()


def test_registered_kernel_cost_is_counted_where_it_launches():
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ragged_paged_flash as rpf

    assert set(op_cost.KERNEL_COSTS) == {
        "ragged_paged_flash", "flash_attention", "paged_flash_decode",
        "rmsnorm", "matmul"}
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    op_cost.kernel_launched("matmul", a, b)  # no counter: nothing happens
    with op_cost.OpCounter() as c:
        op_cost.kernel_launched("matmul", a, b, block=(16, 16, 16),
                                accum="hbm")
    assert c.flops == 2 * 64 * 16 * 32
    assert c.traffic_bytes == mm.policy_bytes(64, 32, 16, torch.float32,
                                              (16, 16, 16), "hbm")
    assert c.kernels == {"matmul": 1}
    # a serving tick: 3 live tokens of 2 slots, one page of 4 keys each
    q = torch.ones(5, 2, 3, 8, dtype=torch.bfloat16)
    kp = vp = torch.ones(6, 4, 2, 8, dtype=torch.bfloat16)
    ptab = torch.tensor([[0, 6], [1, 6]], dtype=torch.int32)
    slot = torch.tensor([0, 0, 1, 0, 0], dtype=torch.int32)
    lens = torch.tensor([1, 2, 4, 0, 0], dtype=torch.int32)
    with op_cost.OpCounter() as c:
        op_cost.kernel_launched("ragged_paged_flash", q, kp, vp, ptab, slot,
                                lens, None, None)
    assert c.flops == 4.0 * 7 * 3 * 2 * 8
    row = 2 * 3 * 8 * 2
    pages = 2 * 2 * (4 * 2 * 8 * 2)  # K and V of pages 0 and 1
    assert c.traffic_bytes == pages + 3 * row + 5 * row + 5 * 4 + 3 * 4 + 2 * 4
    assert rpf.cost(q, kp, vp, ptab, slot, lens) == (c.flops, c.traffic_bytes)


def test_unregistered_kernel_raises():
    op_cost.kernel_launched("no_such_kernel")  # no counter: nothing happens
    with pytest.raises(op_cost.UnregisteredKernel, match="no_such_kernel"):
        with op_cost.OpCounter():
            op_cost.kernel_launched("no_such_kernel", torch.ones(2))


def test_fake_group_is_destroyed_on_exit():
    with op_cost.fake_group(8, rank=3):
        assert dist.get_world_size() == 8 and dist.get_rank() == 3
        with pytest.raises(RuntimeError, match="already initialized"):
            with op_cost.fake_group(4):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with op_cost.fake_group(16):
            1 / 0
    assert not dist.is_initialized()
