"""Per-rank cost of a PyTorch program, counted from the operations it
dispatches.

Counterpart of ``repro.core.hlo_cost``.  JAX walks the compiled, partitioned
HLO text of one device's program; the port runs one process per rank and
writes each rank's program out, so it counts what that program dispatches,
with a ``TorchDispatchMode`` (``OpCounter``), and ``analyze`` returns JAX's
keys:

  - ``flops``: 2 * |result| * K for every matmul-class op (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, their ``.dtype`` forms, ``convolution``; the
    plain attention's products arrive as ``bmm``), as JAX's ``_dot_flops``;
    counted from shapes.
  - ``collective_bytes`` and ``coll_<type>``: JAX's convention, the bytes of
    each collective's RESULT: the gathered tensor of an all-gather, the
    tensor of an all-reduce, the shard of a reduce-scatter, the output of an
    all-to-all (``c10d`` and ``_c10d_functional`` ops alike).
  - ``traffic_bytes``: result bytes of every op that writes a tensor,
    collectives included, as JAX's proxy.  Views count nothing, nor do
    allocations that write nothing (``empty``).  There is no compiler
    fusing ops here, so this counts more than a fused program would.
  - ``peak_bytes``: the high-water mark of the bytes of live storages the
    program touched (arguments, outputs and temporaries), standing for
    JAX's ``memory_analysis`` sum.

The hand-written kernels are launched through ``ctypes``, which no dispatch
mode sees: each wrapper calls ``kernel_launched(name, ...)`` where it
launches, and the cost registered beside the wrapper
(``register_kernel_cost``: the bytes and FLOPs its roofline bound uses)
is added.  A launch with no registered cost raises; it is never counted as
zero.

The counter works on real tensors (under a real process group: gloo or
NCCL ranks) and on fake ones.  ``fake_group`` starts a fake process group
of any size in this one process, so a 256- or 512-rank program is counted
without a card and without data (``torch._subclasses.fake_tensor``).

Time loops (JAX's walker counts a while body once and multiplies it by the
trip count).  ``repeated(n)`` is a region whose dispatched ops count ``n``
times, and so do the ops that the backward nodes recorded inside it
dispatch (the engine's current node, looked up by sequence number: the
node's backward formula and its accumulation into the next node's
gradient); storages made inside it that are still live when the loop ends
(saved for the backward pass, kept in a list of outputs) weigh ``n`` times
in the peak.  ``time_loop`` runs a loop of steps that way where its
tensors have no data (``loop_counted``): the first step, the second
standing for every middle one, and the last, so the boundary steps keep
their own gradients' pattern, and the outputs list holds the middle
step's output in every middle place.  A count of the same program with
every step dispatched stays at hand (``OpCounter(loops="plain")``).
"""
from __future__ import annotations

import bisect
import contextlib
import math
import weakref
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)

# collective op -> (JAX's type, where its result is: an argument index, or
# None for the op's return value)
COLLECTIVES: Dict[str, Tuple[str, object]] = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 0),
    "c10d::_allgather_base_": ("all-gather", 0),
    "c10d::allgather_coalesced_": ("all-gather", 0),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d::alltoall_": ("all-to-all", 0),
    "c10d::alltoall_base_": ("all-to-all", 0),
    "c10d::broadcast_": ("broadcast", 0),
    "c10d::send": ("collective-permute", 0),
    "c10d::recv_": ("collective-permute", 0),
    "_c10d_functional::all_reduce": ("all-reduce", None),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", None),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", None),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", None),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", None),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", None),
    "_c10d_functional::all_to_all_single": ("all-to-all", None),
    "_c10d_functional::broadcast": ("broadcast", None),
}

# ops whose result aliases an input (``OpOverload.is_view`` catches the
# rest) and allocations that write nothing: no traffic
VIEWS = frozenset({
    "aten::view", "aten::_unsafe_view", "aten::expand", "aten::permute",
    "aten::transpose", "aten::slice", "aten::select", "aten::as_strided",
    "aten::alias", "aten::unsqueeze", "aten::squeeze", "aten::t",
    "aten::detach", "aten::split", "aten::split_with_sizes", "aten::chunk",
    "aten::unbind", "aten::narrow", "aten::_reshape_alias", "aten::lift_fresh",
    "_c10d_functional::wait_tensor",
})
ALLOCATIONS = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided",
})


def _k(t: torch.Tensor) -> int:
    return int(t.shape[-1])


def _conv_k(args) -> int:
    """Contraction length of a convolution: input channels a group times
    the kernel's extent (the weight's dims past the first two; a
    transposed convolution's weight is (in, out / groups, ...))."""
    x, w = args[0], args[1]
    transposed = bool(args[6]) if len(args) > 6 else False
    groups = int(args[8]) if len(args) > 8 else 1
    cin = x.shape[1] // groups if transposed else w.shape[1]
    return int(cin) * math.prod(int(d) for d in w.shape[2:])


# matmul-class op -> f(args, result) -> FLOPs: 2 |result| K, K from the
# first matrix operand (JAX's lhs contracting dims)
MATMULS: Dict[str, Callable] = {
    "aten::mm": lambda a, r: 2.0 * r.numel() * _k(a[0]),
    "aten::bmm": lambda a, r: 2.0 * r.numel() * _k(a[0]),
    "aten::addmm": lambda a, r: 2.0 * r.numel() * _k(a[1]),
    "aten::baddbmm": lambda a, r: 2.0 * r.numel() * _k(a[1]),
    "aten::addbmm": lambda a, r: 2.0 * r.numel() * _k(a[1]) * a[1].shape[0],
    "aten::mv": lambda a, r: 2.0 * r.numel() * _k(a[0]),
    "aten::addmv": lambda a, r: 2.0 * r.numel() * _k(a[1]),
    "aten::dot": lambda a, r: 2.0 * _k(a[0]),
    "aten::convolution": lambda a, r: 2.0 * r.numel() * _conv_k(a),
}

# kernel name -> f(*args, **kwargs) -> (FLOPs, bytes) of one wrapper call
# that launched; filled by the kernel modules beside their wrappers
KERNEL_COSTS: Dict[str, Callable] = {}


class UnregisteredKernel(RuntimeError):
    """A counted program launched a kernel that has no registered cost."""


def register_kernel_cost(name: str, cost: Callable) -> Callable:
    """Register ``cost(*args, **kwargs) -> (flops, bytes)`` for the kernel
    wrapper ``name``; returns ``cost``."""
    KERNEL_COSTS[name] = cost
    return cost


def kernel_launched(name: str, *args, **kwargs) -> None:
    """Called by a kernel wrapper where it launches its kernel: adds the
    kernel's registered cost to every active ``OpCounter`` (nothing when
    none is active).  Raises ``UnregisteredKernel`` if the kernel has no
    cost."""
    counters = [m for m in _get_current_dispatch_mode_stack()
                if isinstance(m, OpCounter)]
    if not counters:
        return
    cost = KERNEL_COSTS.get(name)
    if cost is None:
        raise UnregisteredKernel(
            f"kernel {name!r} launched under an OpCounter but has no "
            f"registered cost (op_cost.register_kernel_cost)")
    with _disable_current_modes():  # the cost's own reads are not counted
        flops, nbytes = cost(*args, **kwargs)
    for c in counters:
        k = c._now()
        c.flops += k * float(flops)
        c.traffic_bytes += k * float(nbytes)
        c.kernels[name] = c.kernels.get(name, 0) + int(k)


def counted_only(t: torch.Tensor) -> bool:
    """True where ``t``, a kernel wrapper's argument, belongs to a program
    that is counted and never run: a tensor on ``meta`` (shapes without
    data, the device ``launch.dryrun`` counts the card's program on) or a
    ``FakeTensor`` on ``cuda``.  The wrapper then allocates its output,
    reports the launch with ``kernel_launched`` and returns, touching no
    address; its ``launches`` count stays as it was, since nothing
    launched.  A real CUDA tensor still launches the kernel and a CPU
    tensor, fake or real, still takes the plain version."""
    from torch._subclasses.fake_tensor import FakeTensor

    dev = t.device.type
    return dev == "meta" or (dev == "cuda" and isinstance(t, FakeTensor))


def without_data(t: torch.Tensor) -> bool:
    """A tensor on ``meta`` or a ``FakeTensor`` on any device: a count of
    a program that never runs."""
    from torch._subclasses.fake_tensor import FakeTensor

    return t.device.type == "meta" or isinstance(t, FakeTensor)


def _counters() -> List["OpCounter"]:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCounter)]


def loop_counted(t: torch.Tensor) -> bool:
    """True where a time loop over ``t`` counts one middle step for all of
    them (``time_loop``): ``t`` has no data (``meta``, a ``FakeTensor``)
    and no active counter asks for the plain count.  A tensor with data,
    on the CPU or a card, never: its loop runs every step."""
    return without_data(t) and not any(c.loops == "plain"
                                        for c in _counters())


class _Repeat:
    """The region of ``repeated``: see there."""

    def __init__(self, n: int):
        self.n = n
        self.counters: List["OpCounter"] = []
        self.sets: List[set] = []

    def __enter__(self):
        self.counters = _counters()
        self.lo = torch._C._autograd._get_sequence_nr()
        for c in self.counters:
            c._scale *= self.n
            self.sets.append(c._open_set())
        return self

    def __exit__(self, *exc):
        hi = torch._C._autograd._get_sequence_nr()
        # nodes recorded while the backward pass recomputes a remat'd
        # function never run: only the forward's own are scaled
        forward = torch._C._current_autograd_node() is None
        for c, s in zip(self.counters, self.sets):
            c._scale /= self.n
            c._active = [a for a in c._active if a is not s]
            if forward and hi > self.lo:
                c._scale_nodes(self.lo, hi, self.n)
        return False

    def settle(self) -> None:
        """Weigh the storages made inside the region that are live now
        ``n`` times in the peak (each of the ``n`` steps would have left
        its own); call it where the loop ends."""
        for c, s in zip(self.counters, self.sets):
            c._settle(s, self.n)
        self.counters, self.sets = [], []


def repeated(n: int) -> _Repeat:
    """A context under which every active ``OpCounter`` counts the FLOPs,
    traffic bytes, collective bytes and kernel launches of what is
    dispatched ``n`` times, and so for the backward nodes recorded inside
    it when the backward pass runs them (their formulas and their
    gradients' accumulation).  The handle's ``settle()``, called where the
    loop ends, weighs the storages it made that are still live ``n`` times
    in the peak.  Nests: the counts multiply."""
    return _Repeat(int(n))


def time_loop(n: int, body: Callable, carry, like: torch.Tensor):
    """``body(t, carry) -> (carry, out)`` for t in range(n); returns (the
    last carry, [out_0, ..., out_{n-1}]).  Where ``loop_counted(like)``
    and n > 3 it runs steps 0, 1 and n - 1 only, step 1 under
    ``repeated(n - 2)``, and the list holds step 1's output in every
    middle place (detached past the first, so the gradients that reach
    it are those of the plain loop): a count of the whole loop, forward
    and backward, the boundary steps with their own gradients' pattern."""
    if n <= 3 or not loop_counted(like):
        outs = []
        for t in range(n):
            carry, out = body(t, carry)
            outs.append(out)
        return carry, outs
    rep = repeated(n - 2)
    try:
        carry, first = body(0, carry)
        with rep:
            carry, mid = body(1, carry)
        carry, last = body(n - 1, carry)
    finally:
        # also where a remat recomputation stops early, inside the last
        # step: the middle steps' tensors are then all recomputed
        rep.settle()
    return carry, [first, mid] + [mid.detach()] * (n - 3) + [last]


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors in an op's arguments or result: nested tuples, lists and
    dicts walked by hand (``pytree`` costs several times more per op, and
    a full-size program dispatches hundreds of thousands)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    out = []
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(obj) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(obj)))


LOOP_MODES = ("aware", "plain")


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, collective bytes, traffic bytes and peak live bytes
    of what runs under it (``with OpCounter() as c: ...; c.analyze()``).
    Enter it inside a ``FakeTensorMode`` to count a program on fake
    tensors.  ``loops="plain"`` makes every ``time_loop`` over tensors
    without data dispatch each of its steps (module docstring)."""

    def __init__(self, loops: str = "aware"):
        super().__init__()
        if loops not in LOOP_MODES:
            raise ValueError(f"loops must be one of {LOOP_MODES}, got "
                             f"{loops!r}")
        self.loops = loops
        self.flops = 0.0
        self.traffic_bytes = 0.0
        self.collective_bytes = 0.0
        self.collective_by_type: Dict[str, float] = {}
        self.kernels: Dict[str, int] = {}
        self.peak_bytes = 0.0
        # storage -> a weak reference whose callback takes the storage's
        # bytes (``_bytes``, weighted by ``repeated``) off ``_held`` when it
        # dies: the live bytes are known at every op without a scan
        self._live: Dict[int, weakref.ref] = {}
        self._bytes: Dict[int, float] = {}
        self._held = 0.0
        # ``repeated``: the product of the open regions' counts; the
        # storages each open region made (``_active``), kept with the
        # closed ones until settled (``_unsettled``); the count of the
        # backward nodes, piecewise constant over sequence numbers
        self._scale = 1.0
        self._active: List[set] = []
        self._unsettled: List[set] = []
        self._seq_starts: List[int] = [0]
        self._seq_scales: List[float] = [1.0]

    def _track(self, tensors) -> None:
        """Adds the storages of ``tensors`` not seen yet and raises the
        peak to the bytes of the live storages."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = weakref.ref(st, self._freed(key))
            self._bytes[key] = nbytes
            self._held += nbytes
            for s in self._active:
                s.add(key)
        if self._held > self.peak_bytes:
            self.peak_bytes = float(self._held)

    def _freed(self, key: int):
        def drop(_ref):
            self._live.pop(key, None)
            self._held -= self._bytes.pop(key, 0)
            for s in self._unsettled:
                s.discard(key)
        return drop

    def _open_set(self) -> set:
        s = set()
        self._active.append(s)
        self._unsettled.append(s)
        return s

    def _settle(self, s: set, n: int) -> None:
        for key in s:
            if key in self._bytes:
                extra = self._bytes[key] * (n - 1)
                self._bytes[key] += extra
                self._held += extra
        self._unsettled = [u for u in self._unsettled if u is not s]
        if self._held > self.peak_bytes:
            self.peak_bytes = float(self._held)

    def _scale_nodes(self, lo: int, hi: int, n: int) -> None:
        """The backward nodes of sequence numbers [lo, hi) count n times
        more."""
        starts, scales = self._seq_starts, self._seq_scales
        for b in (lo, hi):
            i = bisect.bisect_right(starts, b) - 1
            if starts[i] != b:
                starts.insert(i + 1, b)
                scales.insert(i + 1, scales[i])
        for i in range(bisect.bisect_left(starts, lo),
                       bisect.bisect_left(starts, hi)):
            scales[i] *= n

    def _now(self) -> float:
        """How many times what is dispatched now counts: the open
        ``repeated`` regions' product, times that of the backward node the
        engine runs."""
        if len(self._seq_starts) == 1:
            return self._scale
        node = torch._C._current_autograd_node()
        if node is None:
            return self._scale
        i = bisect.bisect_right(self._seq_starts, node._sequence_nr()) - 1
        return self._scale * self._seq_scales[i]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        self._track(_tensors((args, kwargs, out)))
        coll = COLLECTIVES.get(name)
        if coll is not None:
            kind, where = coll
            nbytes = self._now() * _nbytes(out if where is None else args[where])
            self.collective_bytes += nbytes
            self.traffic_bytes += nbytes
            self.collective_by_type[kind] = (
                self.collective_by_type.get(kind, 0.0) + nbytes)
            return out
        if name in VIEWS or name in ALLOCATIONS or func.is_view:
            return out
        k = self._now()
        mm = MATMULS.get(name)
        if mm is not None:
            first = out[0] if isinstance(out, (tuple, list)) else out
            self.flops += k * mm(args, first)
        self.traffic_bytes += k * _nbytes(out)
        return out

    def analyze(self) -> Dict[str, object]:
        """JAX's ``hlo_cost.analyze`` keys, ``peak_bytes`` and ``kernels``
        (the hand-written kernels' launches by name)."""
        return {"flops": self.flops,
                "collective_bytes": self.collective_bytes,
                "traffic_bytes": self.traffic_bytes,
                **{f"coll_{k}": v for k, v in self.collective_by_type.items()},
                "peak_bytes": self.peak_bytes,
                "kernels": dict(self.kernels)}


def count(fn: Callable, *args, loops: str = "aware",
          **kwargs) -> Tuple[object, Dict[str, object]]:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter(loops)``; returns
    (its result, the counter's ``analyze()``)."""
    with OpCounter(loops) as c:
        out = fn(*args, **kwargs)
    return out, c.analyze()


COUNT_DEVICES = ("cuda", "cpu")


@contextlib.contextmanager
def counting(device: str):
    """The tensors a count of ``device``'s program runs on, without data:
    yields the device to make them on.  "cuda", the card's program:
    ``meta`` (shapes without data), where the kernel wrappers report
    their registered cost instead of launching (``counted_only``); the
    port's code branches on the device only in those wrappers, and
    autograd cannot run on ``FakeTensor``s on ``cuda`` in a PyTorch built
    without CUDA, so ``meta`` is the card's program on any machine.
    "cpu", the CPU's: ``FakeTensor``s on ``cpu``, the wrappers' plain
    versions counted op by op."""
    if device == "cuda":
        yield torch.device("meta")
        return
    if device != "cpu":
        raise ValueError(f"device must be one of {COUNT_DEVICES}, got "
                         f"{device!r}")
    from torch._subclasses.fake_tensor import FakeTensorMode

    # real constants a program adds in (0-d zeros) become fake ones
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield torch.device("cpu")


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks in this one
    process, this process rank ``rank``: collectives return at once and
    move nothing, which is all a count needs.  Destroyed on exit, also
    after an exception.  Refuses to start over a running group (a group
    left behind would be picked up by a later ``make_mesh``)."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: count "
                           "inside it, without a fake group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
