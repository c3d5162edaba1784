"""Logical-axis layout rules: the port of the JAX package's
``parallel/sharding.py``.

Model code never names mesh axes.  A leaf's layout is a tuple of *logical*
axis names (``serve_step.STATE_AXES``, ``PARAM_AXES``), and a rules table
maps each logical name to mesh axes.  A spec is a plain tuple with one
entry per dimension, as a JAX ``PartitionSpec`` holds them: ``None``
(replicated), a mesh-axis name, or a tuple of two or more names.

The rule functions read only a mesh's axis names and sizes, so they take a
``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh.make_mesh``) or
any object with ``axis_names`` and a ``shape`` mapping of name to size.
``axis_group`` and ``axis_coordinate`` need a real ``DeviceMesh`` (or,
for the coordinate, a ``MeshView``): they give the process group over some
of its axes and this rank's index along them.

Serving: ``head_slice`` and ``gather_heads`` build the engine's KV-head
split on them: a rank's heads of a layer, and the all-gather that makes
its attention output whole before the out-projection.

Training: ``PARAM_AXES`` and ``param_specs`` lay out every parameter leaf
by its name, as JAX's do.  Where JAX places a leaf with a
``NamedSharding`` and lets GSPMD partition the step, a port rank holds
exactly its ``local_slices`` of the leaf (``param_shardings``,
``shard_tensor``), gathers it whole for use (``gather_tensor``), and
sums gradients over the batch axes before keeping its own slice
(``constrain_like_params``).  ``batch_sum`` is the differentiable sum over
the ranks that split the batch, through which the loss and the MoE
balance terms are normalized over the global batch.

The 'model' split of training (Megatron-style tensor parallelism): the
batch is replicated over 'model', so the activations entering a split
layer are the same on every 'model' rank.  The train step makes each split
leaf's working copy its 'model' slice and marks it (``model_slices``); the
layer asks ``model_part`` of its leaf, runs only its slice's products, and
joins the partial results with explicit collectives over the 'model'
group: ``copy_to_model`` (the identity forward, an all-reduce of the
gradient backward) where a split region starts, ``reduce_from_model``
(``sum_over``: an all-reduce forward, the identity backward) where it
ends.  Leaves replicated over 'model' then get the same gradient on every
'model' rank, so ``constrain_like_params`` sums over the batch axes only.
``MODEL_SPLIT`` names the leaves whose layers split and the logical axis
each splits over; ``model_split_dims`` reads from a state's specs which of
them a mesh splits.

The saved residuals' sequence split (JAX's "act_res_seq" rule, Megatron's
sequence parallelism at the remat boundaries): ``res_seq_split`` reads
from the ambient rules whether a sequence splits over 'model';
``keep_rows`` keeps a replicated activation's rank rows (a copy; the
gradient is all-gathered) and ``gather_rows`` makes the rows whole again
(an all-gather; the gradient's rank rows pass back), so what remat saves
between blocks is the rank's S/N rows (``models.transformer.stage_fwd``).

Parts of the JAX module with no counterpart here:

- ``shard_map``: the port runs one process per rank, and each rank calls
  its kernel on its own slice of the tensors (``serve.decode_attention``,
  ``kernels.ops.flash_attention_grouped``).
- ``lshard``: a sharding constraint has nothing to constrain without a
  compiler that places tensors; the port's constraints are its explicit
  collectives (``gather_heads``, ``constrain_like_params``,
  ``keep_rows``/``gather_rows``).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

# ---------------------------------------------------------------------------
# Mesh reading: a DeviceMesh or a stand-in with ``axis_names`` and ``shape``


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in order."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no axis names: build it with "
                         "mesh_dim_names (launch.mesh.make_mesh)")
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in axis_names(mesh)}
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry or rule value as a tuple of mesh-axis names."""
    if not entry:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, entry) -> int:
    """The number of shards a spec entry splits a dimension into."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(entry):
        n *= sizes[a]
    return n


def axis_coordinate(mesh, entry) -> int:
    """This rank's shard index along a spec entry's axes (row-major over
    them, the order ``shard_map`` numbers a multi-axis dimension in)."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in _axes(entry):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


class MeshView:
    """One rank's view of a mesh, without its processes: axis names, sizes
    and this rank's coordinate along each axis.  The rules and the head
    slicing read nothing else, so code run under ``use_mesh(MeshView(..),
    rules)`` computes exactly rank ``coordinate``'s share of the work on a
    single device — how a rank's share is checked where there is one card
    (collectives need a real ``DeviceMesh``)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 coordinate: Sequence[int]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self._coord = dict(zip(self.axis_names, (int(c) for c in coordinate)))

    def get_local_rank(self, axis: str) -> int:
        return self._coord[axis]


_groups: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Any]] = {}


def rank_grid(mesh) -> np.ndarray:
    """The mesh's global ranks as a numpy array of its shape, read on the
    host with every dispatch mode set aside: under a ``FakeTensorMode`` or
    an ``OpCounter`` the mesh's own rank tensor is bookkeeping, not part
    of the program."""
    with _disable_current_modes():
        return mesh.mesh.cpu().numpy()


def axis_group(mesh, entry):
    """The process group of the ranks that differ from this one only along
    a spec entry's axes (a collective over those axes, as JAX's
    ``psum(.., axes)``).  One axis is the mesh's own group; several are
    built once per mesh with ``new_group`` — every rank of the mesh must
    reach the first call for the same axes, as with any collective."""
    axes = _axes(entry)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _groups or _groups[key][0]() is not mesh:
        names = axis_names(mesh)
        ranks = rank_grid(mesh).transpose(
            [names.index(a) for a in names if a not in axes]
            + [names.index(a) for a in axes])
        ranks = ranks.reshape(-1, axes_size(mesh, axes))
        me = dist.get_rank()
        for row in ranks.tolist():  # every rank builds every group
            g = dist.new_group(row)
            if me in row:
                # beside a weak reference to its mesh: a later mesh may
                # reuse a dead one's id (a new fake group for each cell)
                _groups[key] = (weakref.ref(mesh), g)
    return _groups[key][1]


# ---------------------------------------------------------------------------
# Ambient mesh + rules (thread-local so tests can nest)

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_mesh():
    st = _stack()
    return st[-1][0] if st else None


def current_rules() -> Dict[str, Any]:
    st = _stack()
    return st[-1][1] if st else {}


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Any]] = None):
    """Install ``mesh`` and its logical-axis rules (``make_rules(mesh)``
    when none are given) for the code inside."""
    if rules is None:
        rules = make_rules(mesh)
    _stack().append((mesh, rules))
    try:
        yield mesh
    finally:
        _stack().pop()


def ambient() -> Tuple:
    """A snapshot of this thread's ambient stack: every (mesh, rules)
    that ``use_mesh`` and ``axis_rules`` installed, innermost last."""
    return tuple(_stack())


@contextlib.contextmanager
def installed(snapshot: Tuple):
    """Make ``snapshot`` (``ambient()``, possibly taken on another thread)
    this thread's ambient stack for the code inside; the stack as it was
    comes back on exit.  Autograd runs the backward pass, and the
    recomputation of a remat'd function in it, on its device thread on a
    card: ``models.transformer._remat`` installs the forward's snapshot
    around every run of the function, so the recomputation reads the
    forward's mesh and rules."""
    prev = _stack()
    _state.stack = list(snapshot)
    try:
        yield
    finally:
        _state.stack = prev


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Any]):
    """Override logical-axis rules inside the current mesh (e.g. SP decode)."""
    mesh = current_mesh()
    merged = dict(current_rules())
    merged.update(rules)
    _stack().append((mesh, merged))
    try:
        yield
    finally:
        _stack().pop()


# ---------------------------------------------------------------------------
# Rules


def make_rules(mesh, *, heads_tp: bool = False, kv_seq_axis=None,
               decode: bool = False, long_ctx: bool = False) -> Dict[str, Any]:
    """Default logical→physical rules for a (pod,)data×model mesh.

    ``heads_tp``     — shard attention heads over 'model'.
    ``kv_seq_axis``  — shard the KV-cache sequence dim (long-context SP).
    ``decode``       — weight-stationary serving layout: step activations
                       replicate over 'data', KV caches and recurrent states
                       stay batch-sharded over 'data' ("act_kv_batch") and
                       KV-sequence-sharded over 'model' (the distributed
                       flash-decode, ``serve.decode_attention``).
    ``long_ctx``     — batch=1 long-context serving: batch unshardable, KV
                       sequence sharded over ('data', 'model').
    """
    names = axis_names(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    fsdp = batch_axes  # params fully sharded over all data-parallel axes
    kv_batch_axes = batch_axes
    if long_ctx:
        batch_axes = ()
        kv_batch_axes = ()
        kv_seq_axis = kv_seq_axis or ("data", "model")
        decode = True
    elif decode:
        batch_axes = ()  # weight-stationary: step activations replicated
        if kv_seq_axis is None:
            # KV sequence over 'model' (KV heads do not divide in general:
            # qwen1.5 has 20, glm4 has 2)
            kv_seq_axis = ("model",)
    return {
        # ---- weights ----
        "fsdp": fsdp,
        "tensor": "model",
        "vocab": "model",
        "expert": "model",
        "layer": None,  # the stacked layer dim
        None: None,
        # ---- activations ----
        "act_batch": batch_axes,
        "act_kv_batch": kv_batch_axes,  # decode caches / recurrent states
        "act_seq": None,
        "act_res_seq": "model",
        "act_kv_seq": kv_seq_axis,
        "act_embed": None,
        "act_heads": "model" if heads_tp else None,
        "attn_hd": None,
        "act_kv_heads": None,
        "act_ff": "model",
        "act_vocab": "model",
        "act_expert": "model",
    }


def make_serve_rules(mesh) -> Dict[str, Any]:
    """KV-head tensor-parallel rules for the serving engine.

    The paged KV pools (kp/vp and int8 scale pools ks/vs) split along the
    KV-head axis over the mesh's TP axis ('model', else the last); block
    tables, per-slot positions, recurrent states, activations and weights
    replicate, so the engine's host side (PagePool, scheduler, pack
    vectors) does not depend on the rank count and only attention's
    per-head work shrinks per rank.  Attention outputs are all-gathered
    before the output projection, an exact collective, so transcripts are
    token-identical to the 1-device engine's."""
    names = axis_names(mesh)
    ax = "model" if "model" in names else names[-1]
    rules = make_rules(mesh, decode=True)
    rules.update({
        "act_kv_seq": None,  # heads, not sequence, carry the split here
        "act_kv_heads": ax,
        "act_kv_batch": (),  # ptab/kpos/slen replicated: global bookkeeping
        "tensor": None,  # recurrent-state carries stay replicated
        "act_ff": None,
        "act_vocab": None,
        "act_expert": None,
        "vocab": None,
        "expert": None,
        "fsdp": None,  # serving params are replicated (weight-stationary)
    })
    return rules


def _entry(rule):
    """A rule value as a spec entry, normalized as ``PartitionSpec`` does:
    no axis (None or ``()``) is None, one axis its name."""
    axes = _axes(rule)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def logical_spec(names: Sequence[Optional[str]], rules=None) -> tuple:
    """The spec of a leaf whose dims carry the logical ``names``."""
    rules = rules if rules is not None else current_rules()
    return tuple(_entry(rules.get(n, None)) if n is not None else None
                 for n in names)


def sanitize_spec(spec: Sequence, shape, mesh) -> tuple:
    """Drop mesh axes from dims they do not divide (replicate instead),
    right to left until the dim divides."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None:
            out.append(None)
            continue
        axes = list(entry) if isinstance(entry, tuple) else [entry]

        def tot(ax):
            n = 1
            for a in ax:
                n *= sizes[a]
            return n

        while axes and shape[i] % tot(axes) != 0:
            axes.pop()
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return tuple(out)


def local_slices(spec: Sequence, shape, mesh) -> Tuple[slice, ...]:
    """This rank's slice of each dim of a leaf laid out by ``spec`` (a
    sanitized spec: every entry's shard count divides its dim)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec!r} does not fit shape {tuple(shape)}")
    out = []
    for entry, n in zip(tuple(spec), tuple(shape)):
        k = axes_size(mesh, entry)
        if n % k:
            raise ValueError(f"dim {n} does not split {k} ways ({entry!r})")
        step = n // k
        r = axis_coordinate(mesh, entry) if k > 1 else 0
        out.append(slice(r * step, (r + 1) * step))
    return tuple(out)


def local_shape(spec: Sequence, shape, mesh) -> Tuple[int, ...]:
    """A rank's shape of a leaf laid out by ``spec``."""
    return tuple(n // axes_size(mesh, entry)
                 for entry, n in zip(tuple(spec), tuple(shape)))


# ---------------------------------------------------------------------------
# KV-head tensor parallelism (the serving engine's mesh): a rank's heads and
# the gather that makes them whole again


def _head_tp(kvH: int):
    """(mesh, head axes) when a mesh is ambient, the rules map
    "act_kv_heads" to mesh axes and their size (> 1) divides ``kvH``; else
    (None, None): the layer runs on every head, as without a mesh.  JAX's
    ``serve.decode_attention._head_tp``."""
    mesh = current_mesh()
    if mesh is None:
        return None, None
    head_ax = current_rules().get("act_kv_heads")
    if not head_ax:
        return None, None
    tp = axes_size(mesh, head_ax)
    if tp == 1 or kvH % tp != 0:
        return None, None
    return mesh, head_ax


def head_slice(kvH: int) -> Optional[slice]:
    """This rank's KV heads of a layer with ``kvH`` heads under the
    ambient rules, or None where the layer is not split."""
    mesh, h = _head_tp(kvH)
    if mesh is None:
        return None
    n = kvH // axes_size(mesh, h)
    r = axis_coordinate(mesh, h)
    return slice(r * n, (r + 1) * n)


def gather_heads(o, kvH: int):
    """All-gather a rank's attention output (.., kvH/N, G, hd) over the
    head group into (.., kvH, G, hd), heads in rank order: the exact
    collective before the out-projection.  The identity where the layer
    is not split."""
    mesh, h = _head_tp(kvH)
    if mesh is None:
        return o
    # heads first: gathered on dim 0
    return all_gather_cat(o.movedim(-3, 0), axis_group(mesh, h)).movedim(0, -3)


# ---------------------------------------------------------------------------
# Parameter layouts, derived from leaf names (the training half)

# leaf name -> logical axes of the *unstacked* leaf (a stacked stage adds a
# leading "layer" dim); JAX's table, entry for entry
PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / heads
    "tok_embed": ("vocab", "fsdp"),
    "pos_embed": (None, None),
    "out_head": ("fsdp", "vocab"),
    "frontend_proj": (None, "fsdp"),
    # norms
    "scale": (None,),
    "bias": (None,),
    # attention (grouped layout; exactly one of "act_heads"/"attn_hd" maps
    # to 'model' depending on the heads-TP rule)
    "wq": ("fsdp", None, "act_heads", "attn_hd"),
    "wk": ("fsdp", None, "attn_hd"),
    "wv": ("fsdp", None, "attn_hd"),
    "wo": (None, "act_heads", "attn_hd", "fsdp"),
    "bq": (None, "act_heads", "attn_hd"),
    "bk": (None, "attn_hd"),
    "bv": (None, "attn_hd"),
    # dense mlp
    "w_gate": ("fsdp", "tensor"),
    "w_up": ("fsdp", "tensor"),
    "w_down": ("tensor", "fsdp"),
    # moe
    "router": ("fsdp", None),
    "we_gate": ("expert", "fsdp", None),
    "we_up": ("expert", "fsdp", None),
    "we_down": ("expert", None, "fsdp"),
    # mamba
    "in_proj": ("fsdp", "tensor"),
    "conv_w": (None, "tensor"),
    "conv_b": ("tensor",),
    "x_proj": ("tensor", None),
    "dt_w": (None, "tensor"),
    "dt_b": ("tensor",),
    "A_log": ("tensor", None),
    "ssm_D": ("tensor",),
    "out_proj": ("tensor", "fsdp"),
    # xlstm
    "up_proj": ("fsdp", "tensor"),
    "xq": ("tensor", None),
    "xk": ("tensor", None),
    "xv": ("tensor", None),
    "wi": ("tensor", None),
    "wf": ("tensor", None),
    "bi": (None,),
    "bf": (None,),
    "wo_gate": ("tensor", None),
    "down_proj": ("tensor", "fsdp"),
    "w_ifzo": ("fsdp", "tensor"),
    "r_ifzo": (None, "tensor"),
    "b_ifzo": ("tensor",),
    "skip_scale": (None,),
}


def _leaf_spec(name: str, shape, rules, mesh=None) -> tuple:
    """The spec of the parameter ``name`` (a ``Model`` parameter name, as
    ``stages.0.0.mixer.wq``) of ``shape``.  The leaf's rule is its last
    name.  A stage leaf always carries the stacked layer axis here; where
    JAX's leaf has none (a one-repeat stage) the spec is JAX's, sanitized
    on JAX's shape, with None in front — so the two specs agree on every
    dim both have."""
    path = name.split(".")
    leaf = path[-1]
    if leaf not in PARAM_AXES:
        raise ValueError(f"no sharding rule for param leaf {name}")
    axes = PARAM_AXES[leaf]
    shape = tuple(shape)
    lead = ()
    if path[0] == "stages" and len(shape) == len(axes) + 1 and shape[0] == 1:
        lead, shape = (None,), shape[1:]  # JAX's unstacked leaf
    elif len(shape) == len(axes) + 1:  # stacked
        axes = ("layer",) + axes
    elif len(shape) != len(axes):
        raise ValueError(f"param {name} has ndim {len(shape)}, rule expects "
                         f"{len(axes)} (+1 stacked)")
    spec = logical_spec(axes, rules)
    if mesh is not None:
        spec = sanitize_spec(spec, shape, mesh)
    return lead + spec


def param_specs(params, mesh=None, rules=None) -> Dict[str, tuple]:
    """{parameter name: spec} over a ``Model`` (any device, ``meta``
    included: only shapes are read), in ``named_parameters()`` order,
    under ``mesh`` (default: the ambient one) and ``rules`` (default: the
    ambient ones, else ``make_rules(mesh)``)."""
    mesh = mesh if mesh is not None else current_mesh()
    if rules is None:
        rules = current_rules() or (make_rules(mesh) if mesh is not None else {})
    return {name: _leaf_spec(name, p.shape, rules, mesh)
            for name, p in params.named_parameters()}


class Placement(NamedTuple):
    """A leaf's place on a mesh, JAX's ``NamedSharding``: its spec and
    this rank's slice of each dim."""
    spec: tuple
    slices: Tuple[slice, ...]


def param_shardings(params, mesh=None, rules=None) -> Dict[str, Placement]:
    """{parameter name: ``Placement``} over a ``Model`` of full (logical)
    shapes."""
    mesh = mesh if mesh is not None else current_mesh()
    shapes = {n: p.shape for n, p in params.named_parameters()}
    return {n: Placement(s, local_slices(s, shapes[n], mesh))
            for n, s in param_specs(params, mesh, rules).items()}


def shard_tensor(full: torch.Tensor, spec: Sequence, mesh=None) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec``: a contiguous copy of
    its ``local_slices`` (the full tensor itself where nothing splits)."""
    mesh = mesh if mesh is not None else current_mesh()
    if all(axes_size(mesh, e) == 1 for e in spec):
        return full
    return full[local_slices(spec, full.shape, mesh)].contiguous()


def _members(mesh, entry) -> List[int]:
    """The global ranks of this rank's group along a spec entry's axes, in
    the entry's row-major coordinate order (``axis_coordinate``)."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    axes = _axes(entry)
    grid = rank_grid(mesh)
    coord = {a: mesh.get_local_rank(a) for a in names}
    out = []
    for flat in range(axes_size(mesh, axes)):
        r = flat
        for a in reversed(axes):
            coord[a] = r % sizes[a]
            r //= sizes[a]
        out.append(int(grid[tuple(coord[a] for a in names)]))
    return out


@torch.no_grad()
def gather_tensor(local: torch.Tensor, spec: Sequence, mesh=None) -> torch.Tensor:
    """The whole tensor from every rank's shard under ``spec``: an
    all-gather over each split dim's axes, the shards laid out in
    coordinate order (a multi-axis entry such as ``("pod", "data")``
    row-major over its axes, as ``axis_coordinate`` numbers them).  The
    tensor itself (detached) where nothing splits."""
    mesh = mesh if mesh is not None else current_mesh()
    out = local.detach()
    for dim, entry in enumerate(tuple(spec)):
        n = axes_size(mesh, entry)
        if n == 1:
            continue
        group = axis_group(mesh, entry)
        x = out.movedim(dim, 0)
        full = all_gather_cat(x, group)
        members = _members(mesh, entry)
        order = [members.index(g) for g in dist.get_process_group_ranks(group)]
        if order != list(range(n)):  # group order -> coordinate order
            parts = full.view((n,) + tuple(x.shape))
            full = parts[torch.tensor(order).argsort()].reshape(full.shape)
        out = full.movedim(0, dim)
    return out


def constrain_like_params(grads: Sequence[torch.Tensor], specs: Sequence,
                          mesh=None) -> List[torch.Tensor]:
    """Gradients of the whole parameters (one per leaf, in ``specs``'
    order) -> this rank's shards of their sums over the batch axes: an
    all-reduce over the ranks that split the batch (``batch_axes``; none
    where the batch is replicated), then the rank's ``local_slices`` of
    each leaf.  JAX's sharding constraint on the gradient tree, made
    real.

    An all-reduce and not a reduce-scatter, on NCCL too: the slice a rank
    keeps is cut by the leaf's spec, whose split axes are not the batch
    group's in general (a leaf split over 'model' only, or replicated,
    keeps a whole sum on every batch rank), and a reduce-scatter over the
    batch group hands each rank one block of dim 0 in group order.  The
    all-reduce serves every spec with one path, at twice a
    reduce-scatter's bytes on the wire; scattering where the spec splits
    a dim over exactly the batch axes is later work."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return list(grads)
    entry = batch_axes()
    group = axis_group(mesh, entry) if entry is not None else None
    out = []
    for g, spec in zip(grads, specs):
        if group is not None:
            g = g.contiguous()  # NCCL reduces contiguous tensors only
            dist.all_reduce(g, group=group)
        out.append(shard_tensor(g, spec, mesh))
    return out


# ---------------------------------------------------------------------------
# The batch axes: the sums over the ranks that split the batch


def batch_axes():
    """The ambient rules' "act_batch" entry when it splits over more than
    one rank, else None (no mesh, no batch axes, or a batch that the train
    step found not to divide and left whole on every rank)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    entry = _entry(current_rules().get("act_batch"))
    return entry if axes_size(mesh, entry) > 1 else None


def batch_shards() -> int:
    """The number of ranks that split the batch (1 without ``batch_axes``)."""
    entry = batch_axes()
    return 1 if entry is None else axes_size(current_mesh(), entry)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated on dim 0, in the
    group's rank order (``gather_tensor`` reorders to coordinate order
    where the two differ)."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class _SumOver(torch.autograd.Function):
    """All-reduce sum over a group; the gradient passes through unchanged.
    Every rank then holds the same value and differentiates it with
    respect to its own term only, so the gradients summed over the group
    are the summed value's."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` on every rank, differentiably: a rank's
    gradient is that of its own term."""
    return _SumOver.apply(x, group)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that split the batch (``batch_axes``),
    differentiably (``sum_over``), so the gradients summed over the batch
    group (``constrain_like_params``) are the global value's.  ``x``
    itself where the batch is not split."""
    entry = batch_axes()
    if entry is None:
        return x
    return sum_over(x, axis_group(current_mesh(), entry))


# ---------------------------------------------------------------------------
# The 'model' split of training


# leaf name -> the logical axis over which its layer splits its products
# over 'model' in training: the FFN's columns and rows, the vocabulary, the
# experts, the query heads (``heads_tp``) and Mamba's inner channels.
# xLSTM's "tensor" leaves are not split (their layers gather them whole).
MAMBA_LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b",
                "A_log", "ssm_D", "out_proj")
MODEL_SPLIT: Dict[str, str] = {
    "w_gate": "tensor", "w_up": "tensor", "w_down": "tensor",
    "tok_embed": "vocab", "out_head": "vocab",
    "we_gate": "expert", "we_up": "expert", "we_down": "expert",
    "wq": "act_heads", "bq": "act_heads", "wo": "act_heads",
    **{k: "tensor" for k in MAMBA_LEAVES},
}


def model_split_dims(specs: Mapping[str, tuple], mesh) -> Dict[str, int]:
    """{parameter name: the dim (counted from the end) that 'model'
    splits} for every leaf of ``specs`` ({name: sanitized spec}, as
    ``param_specs`` gives them) whose working copy in the train step is
    its 'model' slice: a leaf of ``MODEL_SPLIT`` whose spec puts 'model'
    on its layer's split axis, on a ``mesh`` whose 'model' axis has more
    than one rank.  The spec decides, not the rules:
    ``sanitize_spec`` drops 'model' where it does not divide (2 query
    heads a KV group at 'model' 4).  A Mamba mixer splits as a whole, as
    its ``ssm_D`` (d_in) does; ``conv_w``/``conv_b`` beside no ``ssm_D``
    are an mLSTM's, which stay whole."""
    if axis_sizes(mesh).get("model", 1) == 1:
        return {}
    out = {}
    for name, spec in specs.items():
        group, _, leaf = name.rpartition(".")
        axis = MODEL_SPLIT.get(leaf)
        if axis is None:
            continue
        if leaf in MAMBA_LEAVES:
            d_spec = specs.get(f"{group}.ssm_D" if group else "ssm_D")
            if d_spec is None or d_spec[-1] != "model":
                continue
        axes = PARAM_AXES[leaf]
        dim = axes.index(axis) - len(axes)
        if spec[dim] == "model":
            out[name] = dim
    return out


class ModelPart(NamedTuple):
    """A split leaf's place along 'model': this rank's coordinate, the
    axis size N and the 'model' process group."""
    coord: int
    size: int
    group: Any


# storage of a marked working copy -> its ModelPart.  Process-wide, not
# per thread: on a card the backward pass (and the recomputation of a
# remat'd block in it) runs on autograd's device thread
_PARTS: Dict[int, ModelPart] = {}


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by its views.  Not its data
    address: a storage without data (``meta``, a ``FakeTensor``, counted
    by ``launch.dryrun``) has address 0."""
    return t.untyped_storage()._cdata


@contextlib.contextmanager
def model_slices(tensors: Sequence[torch.Tensor], mesh=None):
    """Mark ``tensors`` (working copies) as this rank's 'model' slices of
    their leaves under ``mesh`` (default: the ambient one) for the code
    inside: ``model_part`` of any of them, or of a view of one, is then
    this rank's ``ModelPart``."""
    mesh = mesh if mesh is not None else current_mesh()
    keys = [_storage_key(t) for t in tensors]
    if keys:
        part = ModelPart(axis_coordinate(mesh, "model"),
                         axes_size(mesh, "model"), axis_group(mesh, "model"))
        _PARTS.update(dict.fromkeys(keys, part))
    try:
        yield
    finally:
        for k in keys:
            _PARTS.pop(k, None)


def model_part(t: torch.Tensor) -> Optional[ModelPart]:
    """The ``ModelPart`` of a leaf whose working copy (``t``, or the copy
    ``t`` views) is this rank's 'model' slice; None where the leaf is
    whole (always outside the train step: serving never splits)."""
    if not _PARTS:
        return None
    return _PARTS.get(_storage_key(t))


class _CopyToModel(torch.autograd.Function):
    """The identity; the gradient is summed over the group.  Where a split
    region starts, each rank's gradient of its input is its own slice's
    share, and the sum is the whole gradient, the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_model(x: torch.Tensor, part: ModelPart) -> torch.Tensor:
    """``x`` (the same on every 'model' rank) entering a split region."""
    return _CopyToModel.apply(x, part.group)


def reduce_from_model(x: torch.Tensor, part: ModelPart) -> torch.Tensor:
    """A split region's partial result summed over 'model' (``sum_over``)."""
    return sum_over(x, part.group)


# ---------------------------------------------------------------------------
# The saved residuals' sequence over 'model' ("act_res_seq")


class RowSplit(NamedTuple):
    """A sequence split over the "act_res_seq" axes: this rank's
    coordinate, the axes' size N and their process group, and the order
    that takes a gather's group order to coordinate order (None where the
    two agree)."""
    coord: int
    size: int
    group: Any
    order: Optional[List[int]]


def res_seq_split(seq_len: int) -> Optional[RowSplit]:
    """The "act_res_seq" split of a sequence of ``seq_len`` positions under
    the ambient mesh and rules; None without a mesh, where the rule names
    no axis or axes of one rank, or where they do not divide ``seq_len``
    (``sanitize_spec`` replicates the dim then)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    entry = sanitize_spec((_entry(current_rules().get("act_res_seq")),),
                          (seq_len,), mesh)[0]
    n = axes_size(mesh, entry)
    if n == 1:
        return None
    group = axis_group(mesh, entry)
    members = _members(mesh, entry)
    order = [members.index(g) for g in dist.get_process_group_ranks(group)]
    return RowSplit(axis_coordinate(mesh, entry), n, group,
                    None if order == list(range(n)) else order)


def _gather_rows(x: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """Every rank's rows (dim 1) of ``split``'s group, whole: (B, S, ...)."""
    full = all_gather_cat(x.movedim(1, 0), split.group)
    if split.order is not None:  # group order -> coordinate order
        parts = full.view((split.size,) + tuple(x.movedim(1, 0).shape))
        full = parts[torch.tensor(split.order).argsort()].reshape(full.shape)
    return full.movedim(0, 1)


def _rank_rows(x: torch.Tensor, split: RowSplit) -> torch.Tensor:
    n = x.shape[1] // split.size
    return x.narrow(1, split.coord * n, n)


class _KeepRows(torch.autograd.Function):
    """A (B, S, ...) activation, the same on every rank of the split ->
    this rank's S/N rows, copied (the whole tensor is not kept alive); the
    gradient all-gathered: each rank's rows carry the gradient of its
    own."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _rank_rows(x, split).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.split), None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows all-gathered into the whole (B, S, ...); the
    gradient, the same on every rank (what follows runs replicated or
    joins its split regions' gradients), gives back the rank's rows."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _gather_rows(x, split)

    @staticmethod
    def backward(ctx, g):
        return _rank_rows(g, ctx.split), None


def keep_rows(x: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """This rank's rows of ``x`` (the same on every rank of ``split``)."""
    return _KeepRows.apply(x, split)


def gather_rows(x: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """The whole sequence from every rank's rows (``keep_rows``'
    inverse)."""
    return _GatherRows.apply(x, split)
