"""The serving step builders of the engine, and the captured step.

Counterpart of ``repro.serve.serve_step.make_ragged_step``: the ragged
engine's one step over a flat (T,) token pack in which every entry carries
its own (slot, position, validity), so any mix of prefill-chunk and decode
tokens runs through the same code.  ``make_paged_step`` builds the two
steps of the two-phase path (``ragged=False``), which the JAX engine builds
inline around ``models.model.paged_step``.  Both run eagerly and update the
state's tensors in place, which is what keeps the pools at fixed addresses.

``make_spec_rollback`` builds speculative decoding's control-plane mover
(JAX ``make_spec_rollback``), which kills the position metadata of
rejected draft rows; ``make_page_gather`` / ``make_page_insert`` build the
host tier's page movers (JAX's of the same names), which run eagerly, on
the current stream, between the captured steps.

``CapturedStep`` is the port of JAX's one jitted program per step: it owns
static input tensors of the step's fixed shapes and, on a CUDA device,
captures the step once into a CUDA graph (``torch.cuda.graph``) and
replays it every call.  ``capture_ragged_step``, ``capture_paged_step`` and
``capture_spec_rollback`` build it for the engine.  The step's writes are
shape-static (``kernels.ops.scatter_live``) and both serving kernels'
wrappers make no host synchronisation, which is what lets the graph hold a
whole step.
"""
from __future__ import annotations

import gc
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.kernels import ragged_paged_flash as rpf
from repro_torch.models import model as M

# eager calls on a side stream before the capture: the kernels' libraries
# build and load, cuBLAS sets up, the decode kernel's split counters exist
WARMUP_CALLS = 2


def make_ragged_step(cfg: ModelCfg, *, width: int, flash_decode: bool = False):
    """Build ``f(params, state, tokens, slot, q_pos, seq_idx, valid,
    logit_idx) -> (logits, state)`` with all pack vectors (T,) and
    ``logit_idx`` (B,) or, speculative, (B, R), tensors on the params'
    device; logits (B, V) or (B, R, V) (see ``models.model.ragged_step``)."""

    @torch.no_grad()
    def ragged_step(params, state, tokens, slot, q_pos, seq_idx, valid,
                    logit_idx):
        return M.ragged_step(params, cfg, state, tokens, slot, q_pos,
                             seq_idx, valid, logit_idx, width=width,
                             flash_decode=flash_decode)

    return ragged_step


def make_paged_step(cfg: ModelCfg, *, with_logits: bool,
                    flash_decode: bool = False):
    """Build ``f(params, state, tokens, q_pos, valid) -> (logits, state)``
    with (B, C) tensors on the params' device (see
    ``models.model.paged_step``): ``with_logits=False`` for the prefill
    chunk, True for the decode tick."""

    @torch.no_grad()
    def paged_step(params, state, tokens, q_pos, valid):
        return M.paged_step(params, cfg, state, tokens, q_pos, valid,
                            with_logits=with_logits,
                            flash_decode=flash_decode)

    return paged_step


def make_spec_rollback(cfg: ModelCfg):
    """Build ``f(state, mask, new_len) -> state``: every masked slot's KV
    rows at positions >= new_len go dead (``kpos`` -1, ``slen`` clamped;
    pools, scales and block tables untouched), in place (see
    ``models.model.rollback_paged_slots``)."""

    @torch.no_grad()
    def spec_rollback(state, mask, new_len):
        return M.rollback_paged_slots(cfg, state, mask, new_len)

    return spec_rollback


def make_page_gather(cfg: ModelCfg):
    """Demotion mover: ``f(state, page) -> {key: rows}``, views of one pool
    page's values and int8 scale rows in every paged leaf (see
    ``models.model.gather_kv_page``); the engine copies them into its host
    store.  Not captured: like JAX's, a control-plane call outside the
    serving step."""
    def page_gather(state, page):
        return M.gather_kv_page(cfg, state, page)

    return page_gather


def make_page_insert(cfg: ModelCfg):
    """Promotion mover: ``f(state, page_data, page) -> state`` writing a
    demoted page's rows back into the pools at device page ``page``, in
    place and without waiting for the host (see
    ``models.model.insert_kv_page``)."""
    @torch.no_grad()
    def page_insert(state, page_data, page):
        return M.insert_kv_page(cfg, state, page_data, page)

    return page_insert


def kernel_launches() -> int:
    """Launches of both serving attention kernels so far, by their
    wrappers' counts."""
    return rpf.launches + pfd.launches


class CapturedStep:
    """One serving step at fixed input shapes, with static inputs.

    ``fn(*inputs)`` runs the step on the static input tensors and returns
    its output tensor or None; it closes over the params and the state,
    which it updates in place.  ``specs`` gives each input's (shape, dtype),
    ``idle`` an all-invalid pack of those shapes, which leaves every state
    leaf bit-identical.

    On a CUDA device with ``capture`` the constructor runs ``fn`` on the
    idle pack ``WARMUP_CALLS`` times on a side stream, then captures one
    call into a CUDA graph, with Python's cyclic garbage collected first
    and the collector off while the capture runs; ``run`` copies a pack into the static inputs
    (through pinned host buffers) and replays the graph.  A failed capture
    or replay raises: nothing falls back to eager.  Without ``capture``, or
    on the CPU, ``run`` calls ``fn`` eagerly on the same static inputs.
    ``launches`` is the number of serving-kernel launches one call makes:
    counted while capturing (the wrappers' counters do not run on replay)
    or, eagerly, over the last call.
    """

    def __init__(self, fn: Callable, specs: Sequence[Tuple[tuple, torch.dtype]],
                 idle: Sequence[np.ndarray], *, device, capture: bool = True):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._fn = fn
        self.inputs = [torch.zeros(shape, dtype=dt, device=self.device)
                       for shape, dt in specs]
        self._host = [torch.zeros(shape, dtype=dt, pin_memory=cuda)
                      for shape, dt in specs]
        # set once the last copies out of the pinned buffers have run, and
        # once the last output has reached its pinned buffer
        self._copied = torch.cuda.Event() if cuda else None
        self._fetched = torch.cuda.Event() if cuda else None
        self.graph = None
        self.launches = 0
        self._out = None
        self._out_host = None
        self._keep: List[torch.Tensor] = []
        if cuda and capture:
            self._capture(idle)

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _load(self, arrays) -> None:
        """Copy host arrays into the static inputs."""
        if self._copied is not None:
            self._copied.synchronize()  # the pinned buffers are free again
        for host, dev, a in zip(self._host, self.inputs, arrays):
            host.numpy()[...] = a
            dev.copy_(host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def _capture(self, idle) -> None:
        self._load(idle)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self._fn(*self.inputs)
        main.wait_stream(side)
        # the graph keeps the decode kernel's split counters it was captured
        # with, even if a later call on the device replaces the buffer
        self._keep = list(pfd._TICKETS.values())
        graph = torch.cuda.CUDAGraph()
        before = kernel_launches()
        # a dead object's CUDA frees (another engine's graphs, events or
        # pinned buffers, held in a reference cycle) invalidate the capture
        # if the collector runs them while it is under way: collect first,
        # and keep the collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._out = self._fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.launches = kernel_launches() - before
        self.graph = graph

    def run(self, *arrays):
        """Run the step on a pack of host arrays (the static inputs'
        shapes and dtypes); returns its output tensor (static when
        captured) or None."""
        self._load(arrays)
        if self.graph is not None:
            self.graph.replay()
            return self._out
        before = kernel_launches()
        self._out = self._fn(*self.inputs)
        self.launches = kernel_launches() - before
        return self._out

    def fetch(self) -> np.ndarray:
        """The last output on the host: copied into a pinned buffer, waited
        on, and returned as a numpy view of that buffer (valid until the
        next ``fetch``)."""
        out = self._out
        if self._out_host is None:
            self._out_host = torch.empty(out.shape, dtype=out.dtype,
                                         pin_memory=self._fetched is not None)
        self._out_host.copy_(out, non_blocking=True)
        if self._fetched is not None:
            self._fetched.record()
            self._fetched.synchronize()
        return self._out_host.numpy()


def _logit_shape(B: int, R: int) -> tuple:
    """``logit_idx``'s shape: (B,) without verify rows, (B, R) with."""
    return (B,) if R == 1 else (B, R)


def idle_ragged_pack(T: int, B: int, width: int, R: int = 1) -> List[np.ndarray]:
    """An all-invalid ragged pack: no token writes, no row is sampled."""
    return [np.zeros(T, np.int32), np.zeros(T, np.int32),
            np.zeros(T, np.int32), np.full(T, width, np.int32),
            np.zeros(T, bool), np.full(_logit_shape(B, R), T, np.int32)]


def idle_paged_pack(B: int, C: int) -> List[np.ndarray]:
    """An all-invalid (B, C) two-phase pack."""
    return [np.zeros((B, C), np.int32), np.zeros((B, C), np.int32),
            np.zeros((B, C), bool)]


def capture_ragged_step(cfg: ModelCfg, params, state, *, T: int, B: int,
                        width: int, R: int = 1, flash_decode: bool = False,
                        capture: bool = True) -> CapturedStep:
    """The ragged step at pack size T over B slots, with R verify rows a
    slot (R = 1 + spec_k; 1 without speculation), as a ``CapturedStep``:
    ``run(tokens, slot, q_pos, seq_idx, valid, logit_idx)`` returns the
    float32 logits, (B, V) at R = 1 and (B, R, V) otherwise; the cast runs
    inside the step."""
    step = make_ragged_step(cfg, width=width, flash_decode=flash_decode)

    def fn(*inputs):
        return step(params, state, *inputs)[0].float()

    i32 = torch.int32
    specs = [((T,), i32)] * 4 + [((T,), torch.bool), (_logit_shape(B, R), i32)]
    return CapturedStep(fn, specs, idle_ragged_pack(T, B, width, R),
                        device=params.device, capture=capture)


def capture_spec_rollback(cfg: ModelCfg, state, *, B: int, device,
                          capture: bool = True) -> CapturedStep:
    """The speculative rollback over B slots as a ``CapturedStep``:
    ``run(mask, new_len)`` with (B,) bool and int32 host arrays, no output.
    Its idle input (no slot masked) leaves the state bit-identical; the
    engine replays it on the step's stream after a tick that rejected
    drafts."""
    rollback = make_spec_rollback(cfg)

    def fn(mask, new_len):
        rollback(state, mask, new_len)

    return CapturedStep(fn, [((B,), torch.bool), ((B,), torch.int32)],
                        [np.zeros(B, bool), np.zeros(B, np.int32)],
                        device=device, capture=capture)


def capture_paged_step(cfg: ModelCfg, params, state, *, B: int, C: int,
                       with_logits: bool, flash_decode: bool = False,
                       capture: bool = True) -> CapturedStep:
    """A two-phase step at (B, C) as a ``CapturedStep``: ``run(tokens,
    q_pos, valid)`` returns None for the prefill chunk (``with_logits``
    False) and the float32 logits (B, V) of the decode tick (C == 1)."""
    step = make_paged_step(cfg, with_logits=with_logits,
                           flash_decode=flash_decode)

    def fn(*inputs):
        logits, _ = step(params, state, *inputs)
        return None if logits is None else logits[:, -1].float()

    specs = [((B, C), torch.int32)] * 2 + [((B, C), torch.bool)]
    return CapturedStep(fn, specs, idle_paged_pack(B, C),
                        device=params.device, capture=capture)
