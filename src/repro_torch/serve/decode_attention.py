"""Distributed decode attention: sequence-parallel flash-decode and the
KV-head tensor-parallel entry points of the paged kernels.

Counterpart of ``repro.serve.decode_attention``.  JAX runs one program over
a mesh and ``shard_map``s each function over it; the port runs one process
per rank, so each function here takes and returns the RANK'S tensors and
reads the ambient mesh and rules (``parallel.sharding.use_mesh``) to find
its shard and its process group.

- ``sp_flash_decode`` — the lock-step path with the KV cache's *sequence*
  dim sharded (decode rules: over 'model'; long-context: over ('data',
  'model')).  Each rank computes the partial online-softmax terms of its
  entries (local max, sum and weighted values); an ``all_reduce(MAX)`` of
  the max and an ``all_reduce(SUM)`` each of the corrected sum and values
  combine them — JAX's ``pmax`` and two ``psum``s.  The payload per layer
  is O(B·kvH·G·hd) whatever the context length.
- ``tp_ragged_paged_flash`` / ``tp_paged_flash_decode`` — under the serving
  engine's mesh the paged pools hold ``kvH/N`` heads on each rank
  (``serve_step.STATE_AXES`` "act_kv_heads"); each rank runs the kernel on
  its own heads of q and its own pools.  Per-head attention needs nothing
  from the other heads, so no collective runs here; the one cross-head
  contraction is the out-projection, after the all-gather
  (``models.layers.attention._out_proj_replicated``).  Which heads are the
  rank's, and the gather, are the mesh's business: JAX's ``_head_tp`` is
  ``parallel.sharding._head_tp``, beside ``head_slice`` and
  ``gather_heads``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import (axes_size, axis_coordinate,
                                           axis_group, current_mesh,
                                           current_rules, head_slice)

NEG_INF = -1e30


def _partial_terms(q, k, v, k_pos, pos, window):
    """q: (B,1,kvH,G,hd); k,v: (B,T,kvH,hd); k_pos: (T,).
    Returns (m (B,kvH,G), l (B,kvH,G), o (B,kvH,G,hd)), float32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgt", q, k).float() * scale
    ok = (k_pos >= 0) & (k_pos <= pos)
    if window is not None:
        ok &= (pos - k_pos) < window
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype), v).float()
    return m, l, o


def _seq_tp():
    """(mesh, sequence axes) when a mesh is ambient and its rules shard
    "act_kv_seq", else (None, None)."""
    mesh = current_mesh()
    seq_ax = current_rules().get("act_kv_seq")
    if mesh is None or not seq_ax:
        return None, None
    return mesh, seq_ax


def seq_shard():
    """(shards, this rank's shard) of the KV sequence dim under the
    ambient rules; (1, 0) without a sequence rule."""
    mesh, seq_ax = _seq_tp()
    if mesh is None:
        return 1, 0
    return axes_size(mesh, seq_ax), axis_coordinate(mesh, seq_ax)


def sp_flash_decode(q, k, v, k_pos, pos, window: Optional[int] = None):
    """Single-token attention over a sequence-sharded KV cache: q
    (B,1,kvH,G,hd), this rank's k/v (B,T/N,kvH,hd) and ``k_pos`` (T/N,),
    ``pos`` the token's position -> (B,1,kvH,G,hd).  Without a mesh or a
    sequence rule, the local computation over the whole cache."""
    mesh, seq_ax = _seq_tp()
    m, l, o = _partial_terms(q, k, v, k_pos, pos, window)
    if mesh is not None:
        import torch.distributed as dist

        group = axis_group(mesh, seq_ax)
        m_g = m.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - m_g)
        l = l * corr
        o = o * corr[..., None]
        dist.all_reduce(l, group=group)
        dist.all_reduce(o, group=group)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype).reshape(q.shape)


# ---------------------------------------------------------------------------
# KV-head tensor-parallel paged flash (the serving engine's mesh= path)


def _rank_q(q, kp):
    """q (N, heads, G, hd) for this rank's pools ``kp`` (.., kvH/N, hd):
    a q with the layer's every head is cut to the rank's
    (``parallel.sharding.head_slice``) and made contiguous, as the kernels
    take contiguous tensors only; a q that already holds the pools' heads
    (the attention layer's own slice) passes as it is."""
    if q.shape[1] == kp.shape[-2]:
        return q
    hs = head_slice(q.shape[1])
    if hs is None or hs.stop - hs.start != kp.shape[-2]:
        raise ValueError(f"q's {q.shape[1]} heads do not map onto the "
                         f"pools' {kp.shape[-2]} under the ambient mesh")
    return q[:, hs].contiguous()


def tp_ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=None, vs=None):
    """``kernels.ops.ragged_paged_flash`` under the engine mesh: the pools
    are this rank's (``kvH/N`` heads), q (T,heads,G,hd) the layer's every
    head (JAX's call) or already the rank's (the attention layer's); the
    kernel runs on the rank's heads and returns (T,kvH/N,G,hd).  With no
    mesh, no "act_kv_heads" rule, one shard or an indivisible head count,
    the whole-pool kernel call."""
    q = _rank_q(q, kp)
    return kops.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)


def tp_paged_flash_decode(q, kp, vp, ptab, lens, ks=None, vs=None):
    """``kernels.ops.paged_flash_decode`` under the engine mesh (the
    two-phase decode tick, q (B,kvH,G,hd)); the same contract as
    ``tp_ragged_paged_flash``."""
    q = _rank_q(q, kp)
    return kops.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)
