"""Logical-axis layout rules: the serving half of the JAX package's
``parallel/sharding.py``.

Model code never names mesh axes.  A leaf's layout is a tuple of *logical*
axis names (``serve_step.STATE_AXES``), and a rules table maps each logical
name to mesh axes.  A spec is a plain tuple with one entry per dimension,
as a JAX ``PartitionSpec`` holds them: ``None`` (replicated), a mesh-axis
name, or a tuple of two or more names.

The rule functions read only a mesh's axis names and sizes, so they take a
``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh.make_mesh``) or
any object with ``axis_names`` and a ``shape`` mapping of name to size.
``axis_group`` and ``axis_coordinate`` need a real ``DeviceMesh`` (or,
for the coordinate, a ``MeshView``): they give the process group over some
of its axes and this rank's index along them.  ``head_slice`` and
``gather_heads`` build the serving engine's KV-head split on them: a rank's
heads of a layer, and the all-gather that makes its attention output whole
before the out-projection.

Parts of the JAX module with no counterpart here:

- ``shard_map``: the port runs one process per rank, and each rank calls
  its kernel on its own slice of the tensors (``serve.decode_attention``).
- ``lshard``: a sharding constraint has nothing to constrain without a
  compiler that places tensors; the port's one constraint on the serving
  path is the explicit all-gather before the out-projection
  (``models.layers.attention._out_proj_replicated``).
- ``PARAM_AXES``, ``param_specs``, ``constrain_like_params`` and
  ``param_shardings``: serving replicates every weight; they come with
  multi-GPU training (ROADMAP.md, Queue 1 item 2).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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


_groups: Dict[Tuple[int, Tuple[str, ...]], Any] = {}


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
    if key not in _groups:
        import torch.distributed as dist

        names = axis_names(mesh)
        ranks = mesh.mesh.permute(
            [names.index(a) for a in names if a not in axes]
            + [names.index(a) for a in axes])
        ranks = ranks.reshape(-1, axes_size(mesh, axes))
        me = dist.get_rank()
        for row in ranks.tolist():  # every rank builds every group
            g = dist.new_group(row)
            if me in row:
                _groups[key] = g
    return _groups[key]


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
    import torch.distributed as dist

    local = o.movedim(-3, 0).contiguous()  # heads first: gathered on dim 0
    full = local.new_empty((kvH,) + local.shape[1:])
    dist.all_gather_into_tensor(full, local, group=axis_group(mesh, h))
    return full.movedim(0, -3)
