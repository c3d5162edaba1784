"""ServeEngine — the continuous-batching serving engine, on PyTorch.

Counterpart of the ragged and two-phase paths of
``repro.serve.engine.ServeEngine``, with the same constructor signature,
request surface (``submit`` / ``cancel`` / ``tick`` / ``run`` / ``stats``)
and scheduling, so that greedy transcripts and the merged ``stats`` are
identical to the JAX engine's on the same weights:

- **Pack.** Each tick packs a fixed token budget ``T`` (``token_budget``):
  decode tokens first (a decoding slot emits every tick), then prefill
  chunks of at most ``prefill_chunk`` tokens per slot in the leftover
  budget, each section in the scheduler's pack order; a slot whose prompt
  completes in the pack appends its first decode token right behind it.
  One step (``serve_step.make_ragged_step``) runs the whole pack.
- **Speculative decoding** (``spec_k > 0``, ragged only; or a
  ``SpeculativeScheduler`` as ``scheduler=``).  A third section of the pack
  takes, in the budget decode and prefill left, each decoding slot's
  prompt-lookup draft chain at its next consecutive positions; the step's
  ``logit_idx`` is (B, 1+spec_k), so one forward returns a verify row per
  draft.  The engine emits the longest agreeing draft prefix plus the token
  sampled from the first disagreeing row, and rolls ``kpos``/``slen`` of
  rejected tails back (``serve_step.capture_spec_rollback``, a second
  captured step).  Sampling is keyed per (request, ordinal), so transcripts
  equal the unspeculated engine's at any temperature.
- **Two-phase path** (``ragged=False``, the JAX engine's A/B baseline).  A
  tick with any prompt left to prefill runs one (B, ``prefill_chunk``)
  chunk step for every such slot; otherwise one (B, 1) decode tick for
  every live slot (``serve_step.make_paged_step``).  As on the ragged path
  (and in JAX), decode resumes from the last prompt token at position L.
- **Pool.** The paged KV pool doubles as a refcounted copy-on-write prefix
  cache (``serve.pool.PagePool``, a copy of the JAX package's): admission
  maps the longest cached prefix, copies a partially matched page before
  the request writes into it, and reserves only the unmatched suffix's
  pages, so no request runs out of pages mid-flight.  The page budget is a
  byte budget (``kv_dtype``: float32 | bfloat16 | int8).  The scheduler
  (``serve.scheduler``: fifo, prefix-aware, slo, class-then-family) orders
  admission and packing; admission still stops at the first candidate whose
  pages do not fit.
- **Host tier** (``host_pages > 0``, with the prefix cache on).  Eviction
  DEMOTES refcount-0 prefix pages to host RAM instead of dropping them, and
  a prefix hit on a host-resident page PROMOTES it back; only a miss in
  both tiers re-prefills.  The pool decides which pages move and logs them
  (``PagePool.drain_events``); the engine applies the log IN ORDER before
  any other device write of the admission round (``_apply_pool_events``),
  through the eager movers ``serve_step.make_page_gather`` /
  ``make_page_insert``, all on the current stream — the stream the
  captured steps replay on — so that a demoted page's bytes leave before
  the page is rewritten and a promoted page's bytes land before the step
  reads them.  The host store is one preallocated tensor per paged leaf,
  indexed by host slot: pinned on a card (the copies are ``non_blocking``,
  so no mover waits for the host; a failed pinned allocation raises), a
  plain tensor on the CPU.  A slot that promoted pages is packed from the
  next tick (``_Slot.ready_tick``), as in JAX.
- **Preemption** (``preempt=True``, the default; ragged only).  When a
  round leaves the head candidate stalled on a slot or on pages that
  running requests hold, and it STRICTLY outranks (``submit(priority=)``) a
  decoding slot, the scheduler's ``preempt_order`` picks a victim: its
  private pages park in the host tier (``PagePool.park``), its shared
  prefix pages are released, and its request re-queues at the head with
  its tokens.  It resumes by unparking (promote-resume) or, when the park
  was refused or lost, by re-prefilling its own history
  (``_Slot.prefill_tokens``) and decoding on from its last token.
  Priority-0 traffic never preempts.
- **Deadlines, backpressure, faults.** ``submit(deadline_ticks=)`` aborts
  a late request with ``DeadlineExceeded``; ``max_queue=`` rejects with
  ``EngineOverloaded``; ``fault_injector=`` (``serve.chaos.FaultInjector``)
  injects allocation failures, cancels (``Cancelled``), host-tier eviction
  storms (parks survive) and stalled ticks.  Faults cost time, never
  tokens: completed transcripts stay identical and both tiers drain.
- **Device.** Params and state live on ``device`` (``cuda`` unless the
  caller passes ``device="cpu"``; with no card and no ``device="cpu"`` the
  constructor raises).  The state's tensors are updated in place, so the
  pools keep their ``data_ptr()`` for the engine's life — the port's
  stand-in for JAX's donation.  With ``flash_decode=True`` attention runs in
  the hand-written CUDA kernels: the ragged step's in
  ``kernels/ragged_paged_flash.py``, the two-phase decode tick's in
  ``kernels/paged_flash_decode.py`` (prefill chunks gather, as in JAX);
  ``stats["kernel_launches"]`` counts the launches of both.
- **Capture.** The first tick with state builds each step of the engine's
  path once at its fixed shapes as a ``serve_step.CapturedStep``: (T,) and
  (B,) for the ragged step; (B, ``prefill_chunk``) for the chunk step and
  (B, 1) for the decode tick of the two-phase path; with speculation the
  ragged step's ``logit_idx`` is (B, R) and the rollback, over (B,) mask
  and new lengths, is a second one.  On a CUDA device each
  is captured into a CUDA graph and replayed every tick — the port of
  JAX's one jitted program per step; a tick copies its pack into the
  step's static inputs from pinned host buffers, and the sampled (B, V) —
  speculative: (B, R, V) — float32 logits come back through a pinned
  buffer; a rollback replays on the same stream, ahead of the next tick.
  ``cuda_graph=False`` runs the same steps eagerly instead, the
  counterpart of running JAX with jit disabled (for A/B checks of the
  capture).  ``stats["traces"]`` counts what JAX counts, its one trace
  of the ragged step at the step's first run (so 1 on a ragged engine that
  has run a step, 0 on the two-phase one); ``stats["graph_captures"]``
  counts the captured graphs of either path (0 on the CPU).  After a
  capture the kernel wrappers' own counters no longer run, so
  ``stats["kernel_launches"]`` adds the launches recorded at capture for
  every replay.

- **Windowed models** (gemma3's sliding-window layers).  A windowed
  layer keeps per-slot circular buffers ``prefill_chunk`` entries longer
  than its window instead of pages; global layers of the same model stay
  paged.  As in JAX, the prefix cache (and so the host tier), speculation
  and preemption need every layer paged and are switched off silently for
  such a model (``stats["spec_k"]`` reads 0), and a model with no paged
  layer takes one block table per slot of pages and reserves none.
- **Recurrent models** (xlstm-350m's mLSTM and sLSTM mixers).  Each slot
  keeps its recurrent state; a step scatters the pack into a (B, width)
  layout and rolls the single-step decode ``width`` times, each slot's
  state advancing only on its valid tokens (``transformer.
  _ragged_recurrent_roll``, JAX's design, inside the captured graph).  The
  gates are the windowed model's: no prefix cache, speculation or
  preemption, and no page is reserved.

Left for a later slice, raising ``NotImplementedError``: tensor
parallelism (``mesh``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M
from repro_torch.models.transformer import POOL_LEAVES
from repro_torch.serve.errors import (Cancelled, DeadlineExceeded,
                                      EngineOverloaded, RequestTooLarge)
from repro_torch.serve.handle import Request, RequestHandle
from repro_torch.serve.pool import (KV_ITEMSIZE, PagePool, _PrefixNode,
                                    kv_bytes_per_token, kv_page_bytes)
from repro_torch.serve.scheduler import (EngineView, Scheduler,
                                         SpeculativeScheduler, make_scheduler)
from repro_torch.serve.serve_step import (CapturedStep, capture_paged_step,
                                          capture_ragged_step,
                                          capture_spec_rollback,
                                          make_page_gather, make_page_insert)

__all__ = ["ServeEngine", "kv_page_bytes", "kv_bytes_per_token"]


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: List[int]
    fill: int = 0  # prompt tokens in cache (matched prefix + prefilled)
    pos: int = 0  # next absolute write position (== len(prompt) at decode)
    last_tok: int = 0
    # prefix-cache bookkeeping: the trie node matching the indexed prefix so
    # far (None = this slot's prefix is owned elsewhere, stop indexing) and
    # how many of this slot's leading pages are on that trie chain
    node: Optional[_PrefixNode] = None
    n_indexed: int = 0
    # first tick this slot may be packed: an admission that promoted host
    # pages waits one tick, as in JAX (the movers and the step share one
    # stream, so correctness never depends on it; pack composition does)
    ready_tick: int = 0
    # what prefill feeds the pack: the prompt, or, for a preempted request
    # that re-prefills, its history (prompt, the position-L handoff
    # duplicate, generated tokens but the last), whose length IS the
    # preempted write position
    prefill_tokens: Optional[np.ndarray] = None
    # decode input once prefill completes, when it is not the last prefill
    # token (a re-prefilled request resumes from its last generated token)
    resume_tok: Optional[int] = None

    def __post_init__(self):
        if self.prefill_tokens is None:
            self.prefill_tokens = self.req.prompt


class ServeEngine:
    def __init__(self, params: M.Model, cfg: ModelCfg, *, batch_size: int = 4,
                 cache_len: int = 256, page_size: int = 16,
                 max_pages: Optional[int] = None, prefill_chunk: int = 32,
                 token_budget: int = 128, greedy: bool = True,
                 ragged: bool = True, flash_decode: bool = False,
                 prefix_cache: bool = True, kv_dtype: Optional[str] = None,
                 scheduler=None, mesh=None, host_pages: int = 0,
                 spec_k: int = 0, preempt: bool = True,
                 max_queue: Optional[int] = None, fault_injector=None,
                 device=None, cuda_graph: bool = True):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh=) is not ported yet: it comes "
                "with the multi-GPU slice of the PyTorch port (ROADMAP.md, "
                "Queue 1)")
        self.scheduler = make_scheduler(scheduler)
        # speculation rides the policy layer, as in JAX: spec_k wraps the
        # policy in a SpeculativeScheduler, or one comes as scheduler=
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k and not isinstance(self.scheduler, SpeculativeScheduler):
            if not ragged:
                raise ValueError("speculative decoding needs the ragged "
                                 "path (spec_k > 0 with ragged=False)")
            self.scheduler = SpeculativeScheduler(self.scheduler,
                                                  spec_k=spec_k)
        self.scheduler_name = getattr(self.scheduler, "name",
                                      type(self.scheduler).__name__)
        # policies that keep the identity orders skip the per-tick
        # EngineView (the probes see through the speculative wrapper)
        probe = (self.scheduler.inner
                 if isinstance(self.scheduler, SpeculativeScheduler)
                 else self.scheduler)
        cls = type(probe)
        self._default_admit = (
            getattr(cls, "admission_order", None) is Scheduler.admission_order)
        self._default_pack = (
            getattr(cls, "decode_order", None) is Scheduler.decode_order
            and getattr(cls, "prefill_order", None) is Scheduler.prefill_order)
        # JAX's gates for windowed models: a windowed layer keeps per-slot
        # circular buffers, which no other slot can inherit and which a
        # write advances destructively, so the prefix cache (and with it the
        # host tier), speculation (nothing to roll back to) and preemption
        # (no page holds a windowed layer's state) need every layer to be
        # paged global attention; a windowed model serves with them off,
        # silently, and stats["spec_k"] reports 0
        M.check_servable(cfg)
        self._has_paged = any(blk.mixer == "attn" and blk.attn.window is None
                              for st in cfg.stages for blk in st.pattern)
        all_global = self._has_paged and all(
            blk.mixer == "attn" and blk.attn.window is None
            for st in cfg.stages for blk in st.pattern)
        self._spec_k = (int(getattr(self.scheduler, "spec_k", 0))
                        if all_global else 0)
        self._draft = getattr(self.scheduler, "draft", None)
        if self._draft is None:
            self._spec_k = 0
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.B = batch_size
        self.cache_len = cache_len
        self.page_size = page_size
        self.chunk = prefill_chunk
        self.budget = token_budget
        # most tokens one slot adds to a pack: a prefill chunk and its
        # handoff decode token, or a decode token and its draft chain
        self.width = max(prefill_chunk + 1, 1 + self._spec_k)
        self.greedy = greedy
        self.ragged = ragged
        self.flash_decode = flash_decode
        self.cuda_graph = cuda_graph
        self.kv_dtype = str(kv_dtype or cfg.dtype)
        if self.kv_dtype not in KV_ITEMSIZE:
            raise ValueError(f"unsupported kv_dtype {self.kv_dtype!r} "
                             f"(pick from {sorted(KV_ITEMSIZE)})")
        if ragged and token_budget < batch_size:
            raise ValueError(
                f"token_budget={token_budget} < batch_size={batch_size}: "
                "every decoding slot needs one pack entry per tick")
        # preemption resumes through the ragged pack (JAX's gate)
        self.preempt = bool(preempt) and ragged and all_global
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.fault_injector = fault_injector
        # uid -> park record of a preempted request awaiting re-admission:
        # "slots" (host slots holding its pages [page0, page0 + len), None
        # when the park was refused: resume re-prefills), "pos"/"last_tok"
        self._preempted: Dict[int, dict] = {}
        self._chaos_alloc_fail = False
        self.pps = -(-cache_len // page_size)  # block-table width
        self.prefix_cache = bool(prefix_cache) and all_global
        # the page budget is a BYTE budget: the same bytes the activation-
        # dtype pool would take, never below one full block table per slot
        # (a model with no paged layer takes that floor)
        base_pages = batch_size * self.pps
        if max_pages is not None:
            self.n_pages = max_pages
        elif self._has_paged:
            ref = kv_page_bytes(cfg, page_size, cfg.dtype)
            act = kv_page_bytes(cfg, page_size, self.kv_dtype)
            self.n_pages = max(base_pages, base_pages * ref // max(act, 1))
        else:
            self.n_pages = base_pages
        # the host tier only matters with the prefix cache on (and for
        # parks, which JAX gates the same way)
        self.host_pages = host_pages if self.prefix_cache else 0
        self.pool = PagePool(self.n_pages, page_size,
                             index_enabled=self.prefix_cache,
                             host_pages=self.host_pages)
        # host tier bytes: {paged-leaf key: (host_pages, ...) tensor}, built
        # with the state; _host_slots mirrors which slots hold bytes
        self._host_store: Dict[str, torch.Tensor] = {}
        self._host_slots: set = set()
        self._gather_page = make_page_gather(cfg)
        self._insert_page = make_page_insert(cfg)
        self.queue: deque = deque()
        self.slots: List[Optional[_Slot]] = [None] * batch_size
        self._uid = 0
        self.completion_order: List[int] = []
        self._state = None  # persistent: the pool doubles as the prefix cache
        page_bytes = kv_page_bytes(cfg, page_size, self.kv_dtype)
        # the JAX engine's keys, then the port's own
        self._stats = {"chunk_ticks": 0, "decode_ticks": 0, "ragged_ticks": 0,
                       "ticks": 0, "packed_tokens": 0, "traces": 0,
                       "pages_in_use_peak": 0, "admissions": 0,
                       "prefix_hits": 0, "prefix_tokens_reused": 0,
                       "cow_copies": 0, "cancelled": 0,
                       "host_hits": 0, "host_pages_promoted": 0,
                       "host_pool_pages": self.host_pages,
                       "scheduler": self.scheduler_name,
                       "spec_k": self._spec_k, "spec_drafted": 0,
                       "spec_accepted": 0, "spec_rejected": 0,
                       "spec_rollbacks": 0, "sampled_slot_ticks": 0,
                       "preemptions": 0, "resumes": 0,
                       "resume_park_hits": 0, "resume_reprefills": 0,
                       "preempt_pages_parked": 0, "deadline_expired": 0,
                       "overload_rejections": 0, "chaos_alloc_fails": 0,
                       "chaos_cancels": 0, "chaos_evict_storms": 0,
                       "chaos_stalled_ticks": 0,
                       "kv_dtype": self.kv_dtype,
                       "kv_bytes_per_token": kv_bytes_per_token(
                           cfg, self.kv_dtype),
                       "kv_pool_bytes": self.n_pages * page_bytes,
                       "kv_shards": 1, "n_devices": 1,
                       "kv_pool_bytes_per_device": self.n_pages * page_bytes,
                       # launches of the CUDA attention kernels by this
                       # engine's steps (0 on the CPU, which runs the plain
                       # versions)
                       "kernel_launches": 0,
                       # CUDA graphs captured by this engine (port only)
                       "graph_captures": 0}
        # per-token / per-tick logs for the latency benchmark
        # (benchmarks/serve_sweep.py), host-only: token_log rows are (uid,
        # tick index, wall time) per booked token; tick_log rows are (had
        # outstanding prefill at tick start, wall time at tick end).  A
        # booked token's wall time follows its step's logits fetch, which
        # waits for the step on the card (serve_step.CapturedStep.fetch)
        self.token_log: List[tuple] = []
        self.tick_log: List[tuple] = []
        # the steps, built with the state (_ensure_state)
        self._ragged_step = self._chunk_step = self._decode_step = None
        self._rollback = None

    # -- public surface ---------------------------------------------------
    def submit(self, prompt, max_tokens: int = 16, eos_id=None, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None,
               priority: int = 0,
               deadline_ticks: Optional[int] = None) -> RequestHandle:
        """Queue one request; returns a streaming ``RequestHandle`` (an
        ``int`` subclass carrying the uid).  ``priority`` is the scheduling
        class (>= 1 interactive, 0 batch; the slo policies read it, and a
        stalled request preempts only a strictly lower class).
        ``deadline_ticks`` arms a completion deadline that many ticks from
        now (an expired request aborts with ``DeadlineExceeded``); a
        request that can never fit rejects with ``RequestTooLarge``; with
        ``max_queue=`` set, a submit to a full queue rejects with
        ``EngineOverloaded``."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if prompt.size + max_tokens > self.cache_len:
            raise RequestTooLarge(
                f"len(prompt)+max_tokens = {prompt.size + max_tokens} "
                f"exceeds cache_len={self.cache_len}")
        if temperature is None:
            temperature = 0.0 if self.greedy else 1.0
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if deadline_ticks is not None and deadline_ticks < 1:
            raise ValueError(
                f"deadline_ticks must be >= 1, got {deadline_ticks}")
        if (self.max_queue is not None
                and len(self.queue) >= self.max_queue):
            self._stats["overload_rejections"] += 1
            raise EngineOverloaded(
                f"admission queue full ({len(self.queue)} >= "
                f"max_queue={self.max_queue}): shed load or retry later")
        self._uid += 1
        req = Request(self._uid, prompt, max_tokens, eos_id,
                      temperature=temperature, top_k=top_k, seed=seed,
                      priority=priority)
        if deadline_ticks is not None:
            req.deadline_tick = self._stats["ticks"] + deadline_ticks
        # validate against the cold-start worst case: the cache may churn
        # before this request reaches the head of the queue
        need = self._pages_needed(req)
        if need > self.n_pages:
            raise RequestTooLarge(
                f"request needs {need} pages but the pool has only "
                f"{self.n_pages} (raise max_pages or shrink the request)")
        self.queue.append(req)
        return RequestHandle(req, self)

    def cancel(self, handle_or_uid, *,
               error: Optional[Exception] = None) -> bool:
        """Stop a request and release what it holds: a queued request is
        dequeued (a preempted one drops its park); an admitted one frees
        its slot and drops its page references (shared prefix pages survive
        for siblings and the cache).  Returns False for finished or unknown
        requests.  ``error`` marks an engine-initiated abort, raised by
        ``result()``/``tokens()``."""
        uid = int(handle_or_uid)
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                self._drop_park_record(uid)
                self._finish_cancel(req, error)
                return True
        for b, s in enumerate(self.slots):
            if s is not None and s.req.uid == uid:
                self._finish_cancel(s.req, error)
                self._release_slot(b)
                return True
        return False

    def _finish_cancel(self, req: Request,
                       error: Optional[Exception]) -> None:
        req.cancelled = req.done = True
        if error is not None:
            if hasattr(error, "tokens") and not error.tokens:
                error.tokens = list(req.out_tokens)
            req.error = error
        self._stats["cancelled"] += 1

    def _drop_park_record(self, uid: int) -> None:
        """Forget a preempted request's park (cancel, deadline, drain): its
        host slots free, and their hevicts, which need no device work, are
        drained at once when nothing else is pending."""
        rec = self._preempted.pop(uid, None)
        if rec is None or rec["slots"] is None:
            return
        self.pool.drop_parked(rec["slots"])
        if self.pool.events and all(
                ev[0] == "hevict" for ev in self.pool.events):
            for ev in self.pool.drain_events():
                self._host_slots.discard(ev[1])

    @property
    def stats(self) -> Dict:
        """Engine counters merged with the pool's (read-only snapshot)."""
        return {**self._stats, **self.pool.stats}

    # -- pool passthroughs (the JAX engine's surface; drivers use these) --
    @property
    def _ref(self) -> np.ndarray:
        return self.pool._ref

    @property
    def cached_pages(self) -> int:
        """Pages currently held by the prefix index."""
        return self.pool.cached_pages

    @property
    def reclaimable_pages(self) -> int:
        """Free pages plus refcount-0 cached pages; equals ``n_pages``
        whenever no request is live."""
        return self.pool.reclaimable_pages

    def drop_prefix_cache(self) -> int:
        """Discard every refcount-0 cached page in BOTH tiers.  Returns the
        number of device pages returned to the free list."""
        n = self.pool.drop_cache()
        for ev in self.pool.drain_events():  # hevicts only
            self._host_slots.discard(ev[1])
        return n

    def pool_tensors(self) -> List[torch.Tensor]:
        """Every KV pool tensor of the state (values and int8 scales)."""
        self._ensure_state()
        return [c[k] for ss in self._state["layers"] for c in ss
                for k in POOL_LEAVES if k in c]

    def _apply_pool_events(self, state):
        """Apply the pool's tier-traffic log IN ORDER, before any other
        device write of the round: ("demote", page, slot) copies the page's
        rows into host slot ``slot`` before the freed page can be reused,
        ("promote", slot, page) copies them back into the new device page,
        ("hevict", slot) forgets the slot.  Every copy is queued on the
        current stream, which the captured steps replay on, in the log's
        order — a slot freed by a promote and reused by a later demote of
        the same round is read before it is overwritten — and none waits
        for the host (pinned store, ``non_blocking``)."""
        for ev in self.pool.drain_events():
            if ev[0] == "demote":
                _, page, slot = ev
                for key, rows in self._gather_page(state, page).items():
                    self._host_store[key][slot].copy_(rows, non_blocking=True)
                self._host_slots.add(slot)
            elif ev[0] == "promote":
                _, slot, page = ev
                state = self._insert_page(
                    state, {k: v[slot] for k, v in self._host_store.items()},
                    page)
                self._host_slots.discard(slot)
            else:  # ("hevict", slot)
                self._host_slots.discard(ev[1])
        return state

    # -- admission --------------------------------------------------------
    def _pages_needed(self, req: Request, matched_pages: int = 0) -> int:
        """Pages the request must RESERVE: its full footprint minus the
        ``matched_pages`` shared prefix pages it maps instead (none when no
        layer is paged)."""
        if not self._has_paged:
            return 0
        total = -(-(len(req.prompt) + req.max_tokens) // self.page_size)
        return total - matched_pages

    def _view(self, include_queue: bool = True) -> EngineView:
        # pack-order consultations get an empty queue (documented on
        # EngineView)
        return EngineView(
            queue=tuple(self.queue) if include_queue else (),
            slot_requests=tuple(s.req if s is not None else None
                                for s in self.slots),
            slot_fill=tuple(s.fill if s is not None else 0
                            for s in self.slots),
            budget=self.budget, chunk=self.chunk, page_size=self.page_size,
            match_len=self.pool.probe_prefix_len,
            match_split=self.pool.probe_prefix_split)

    def _pack_order(self, order, slots_in: List[int],
                    fn_name: str) -> List[int]:
        """A pack order must PERMUTE the engine's slot list: a duplicate
        would sample a slot twice, an omission would stall a decoder."""
        order = list(order)
        if sorted(order) != sorted(slots_in):
            raise ValueError(
                f"{self.scheduler_name}: {fn_name} must permute "
                f"{slots_in}, got {order}")
        return order

    def _admission_candidates(self) -> List[Request]:
        """This round's candidates in the scheduler's order, validated to
        a duplicate-free in-range sequence of queue indices."""
        view = self._view()
        order = list(self.scheduler.admission_order(view))
        n = len(view.queue)
        if len(set(order)) != len(order) or any(
                not (0 <= i < n) for i in order):
            raise ValueError(
                f"{self.scheduler_name}: admission_order returned "
                f"{order!r} for a {n}-deep queue")
        return [view.queue[i] for i in order]

    def _admit_round(self, state):
        """Admit queued candidates, in the scheduler's order, into free
        slots while the pages each actually needs — its unmatched suffix
        after the longest cached prefix, plus one per host-tier hit to
        promote — fit in free + evictable pages; stop at the first that
        does not (no mid-flight OOM).  A mid-page prefix match copies the
        page (COW) into one the request owns before it writes there.

        A preempted candidate (a ``_preempted`` record) re-admits one of two
        ways: its park promotes back — trie pages cover the front, unparked
        pages the middle, fresh pages the tail — and decode resumes at the
        recorded position on the next tick; or, when the park was refused
        or the cached prefix shrank beneath it, it re-prefills its history
        and resumes from its last generated token."""
        if not self.queue or all(s is not None for s in self.slots):
            return state
        mask = np.zeros(self.B, bool)
        rows = np.full((self.B, self.pps), self.n_pages, np.int32)
        plen = np.zeros(self.B, np.int32)
        # unused COW pairs keep the n_pages sentinel (no-op copies)
        cow_src = np.full(self.B, self.n_pages, np.int32)
        cow_dst = np.full(self.B, self.n_pages, np.int32)
        cow_pins: List[int] = []
        n_cow = 0
        # FIFO admission peeks the queue head; a reordering policy pays for
        # the candidate snapshot and the queue rebuild
        cands = None if self._default_admit else self._admission_candidates()
        admitted: set = set()
        ci = 0
        tick = self._stats["ticks"]
        for b in range(self.B):
            if self.slots[b] is not None:
                continue
            if cands is None:
                if not self.queue:
                    continue
                req = self.queue[0]
            else:
                if ci >= len(cands):
                    continue
                req = cands[ci]
            rec = self._preempted.get(req.uid)
            node, mpages, matched, cow = self.pool.match_prefix(req.prompt)
            if rec is not None:
                cow = None  # a resume's coverage is its park or its history
            # host-tier hits are matchable but each costs a device page to
            # promote: demand, not supply
            n_host = sum(1 for p in mpages if self.pool.is_host(p))
            parked = rec["slots"] if rec is not None else None
            resume_hit = parked is not None and len(mpages) >= rec["page0"]
            if resume_hit:
                # trie pages cover [0, mp), the park [page0, page0 +
                # len(parked)): the trie's copy wins the overlap, the rest
                # unparks, fresh pages cover the footprint's tail
                mp = len(mpages)
                keep = parked[mp - rec["page0"]:]
                ncover = rec["page0"] + len(parked)
                need = -(-(len(req.prompt) + req.max_tokens)
                         // self.page_size) - ncover
                demand = need + len(keep) + n_host
            else:
                need = self._pages_needed(req, matched_pages=len(mpages))
                demand = need + n_host
            if cow is not None and need + n_host > self.pool.available(
                    mpages + [cow[0]]):
                cow = None  # pinning the COW source would leave the pool
                # short one page: forgo the partial-page reuse
            if demand > self.pool.available(mpages):
                break  # stop at the first infeasible candidate
            if cands is None:
                self.queue.popleft()
            else:
                ci += 1
                admitted.add(req.uid)
            mpages = self.pool.acquire(mpages)  # +1 ref each; promotes
            if n_host:
                self._stats["host_hits"] += 1
                self._stats["host_pages_promoted"] += n_host
            if rec is not None:
                self._preempted.pop(req.uid)
                self._stats["resumes"] += 1
            if resume_hit:
                if len(keep) < len(parked):
                    self.pool.drop_parked(parked[:len(parked) - len(keep)])
                pages = mpages + self.pool.unpark(keep) \
                    + self.pool.alloc(need)
                rows[b, :len(pages)] = pages
                plen[b] = rec["pos"]
                self.slots[b] = _Slot(
                    req, pages, fill=len(req.prompt), pos=rec["pos"],
                    last_tok=rec["last_tok"], node=node,
                    n_indexed=len(mpages), ready_tick=tick + 1)
                mask[b] = True
                self._stats["admissions"] += 1
                self._stats["resume_park_hits"] += 1
                if matched:
                    self._stats["prefix_hits"] += 1
                    self._stats["prefix_tokens_reused"] += matched
                continue
            ptoks, rtok = req.prompt, None
            if rec is not None:
                # no usable park: re-prefill the history; its length is the
                # preempted write position
                if parked is not None:
                    self.pool.drop_parked(parked)
                ptoks = np.concatenate(
                    [req.prompt, req.prompt[-1:],
                     np.asarray(req.out_tokens[:-1], np.int32)])
                rtok = int(rec["last_tok"])
                self._stats["resume_reprefills"] += 1
            if cow is not None:
                self.pool.share([cow[0]])  # pin the COW source vs eviction
                cow_pins.append(cow[0])
            alloc = self.pool.alloc(need)  # arrives refcounted
            if cow is not None:
                cow_src[b], cow_dst[b] = cow[0], alloc[0]
                matched += cow[1]
                n_cow += 1
            pages = mpages + alloc
            rows[b, :len(pages)] = pages
            plen[b] = matched
            s = _Slot(req, pages, fill=matched, node=node,
                      n_indexed=len(mpages), prefill_tokens=ptoks,
                      resume_tok=rtok, ready_tick=tick + 1 if n_host else tick)
            if matched >= len(ptoks):
                # whole prompt cached: straight to decode from the last
                # prompt token at position L
                s.pos = len(ptoks)
                s.last_tok = int(ptoks[-1])
            self.slots[b] = s
            mask[b] = True
            self._stats["admissions"] += 1
            if matched:
                self._stats["prefix_hits"] += 1
                self._stats["prefix_tokens_reused"] += matched
        if mask.any():
            if admitted:
                self.queue = deque(r for r in self.queue
                                   if r.uid not in admitted)
            self._stats["pages_in_use_peak"] = max(
                self._stats["pages_in_use_peak"], self.pool.pages_in_use)
            # tier traffic first: demotions read pages the COW copy, the
            # reset and the step may overwrite; promotions land before them
            state = self._apply_pool_events(state)
            if n_cow:
                state = M.copy_kv_pages(self.cfg, state, cow_src, cow_dst)
                self._stats["cow_copies"] += n_cow
            self.pool.release(cow_pins)
            dev = self.device
            state = M.reset_paged_slots(
                self.cfg, state, self._template,
                torch.from_numpy(mask).to(dev), torch.from_numpy(rows).to(dev),
                torch.from_numpy(plen).to(dev))
        return state

    # -- preemption -------------------------------------------------------
    def _admit(self, state):
        """Admission with a preemption backstop: while the round leaves its
        head candidate stalled and that candidate STRICTLY outranks a
        decoding slot, preempt one victim and run the round again.  Equal
        classes never preempt each other (no thrash), so priority-0 traffic
        never preempts."""
        if self._chaos_alloc_fail:
            return state  # injected allocation failure: nothing admits
        state = self._admit_round(state)
        if not self.preempt:
            return state
        for _ in range(self.B):  # each pass frees one slot at most
            cand = self._stalled_candidate()
            if cand is None:
                break
            b = self._pick_victim(cand)
            if b is None:
                break
            state = self._preempt_slot(b, state)
            state = self._admit_round(state)
        return state

    def _stalled_candidate(self) -> Optional[Request]:
        """The first candidate a round left queued (None when the queue is
        empty): the request a preemption would be for."""
        if not self.queue:
            return None
        if self._default_admit:
            return self.queue[0]
        cands = self._admission_candidates()
        return cands[0] if cands else None

    def _pick_victim(self, cand: Request) -> Optional[int]:
        """A decoding slot of strictly lower priority whose preemption lets
        ``cand`` admit, in the policy's ``preempt_order`` (which may exempt
        slots); None when there is none."""
        tick = self._stats["ticks"]
        victims = [b for b, s in enumerate(self.slots)
                   if s is not None and s.ready_tick <= tick
                   and s.fill >= len(s.prefill_tokens)
                   and s.req.priority < cand.priority]
        if not victims:
            return None
        po = getattr(self.scheduler, "preempt_order", None)
        view = self._view()
        order = list(po(view, victims) if po is not None
                     else Scheduler.preempt_order(self.scheduler, view,
                                                  victims))
        if len(set(order)) != len(order) or any(
                b not in victims for b in order):
            raise ValueError(
                f"{self.scheduler_name}: preempt_order returned {order!r} "
                f"for victims {victims}")
        for b in order:
            if self._admits_after(cand, self.slots[b]):
                return b
        return None

    def _admits_after(self, req: Request, s: _Slot) -> bool:
        """Would preempting ``s`` make ``req`` admissible?  Counts the pages
        the victim holds alone against the candidate's demand, probed
        without touching LRU state."""
        _, mpages, _ = self.pool._walk_full_pages(req.prompt, touch=False)
        gain = sum(1 for p in s.pages if self.pool.ref(p) == 1)
        n_host = sum(1 for p in mpages if self.pool.is_host(p))
        rec = self._preempted.get(req.uid)
        if (rec is not None and rec["slots"] is not None
                and len(mpages) >= rec["page0"]):
            keep = len(rec["slots"]) - (len(mpages) - rec["page0"])
            ncover = rec["page0"] + len(rec["slots"])
            demand = (-(-(len(req.prompt) + req.max_tokens)
                        // self.page_size) - ncover) + keep + n_host
        else:
            demand = self._pages_needed(
                req, matched_pages=len(mpages)) + n_host
        return demand <= self.pool.available(mpages) + gain

    def _preempt_slot(self, b: int, state):
        """Preempt decoding slot ``b``: park its private pages (positions
        [0, pos) past its indexed prefix) in the host tier, release the
        rest, and re-queue its request at the head with its tokens.  The
        park's demotions apply at once: the next round may reuse the
        freed pages."""
        s = self.slots[b]
        req = s.req
        ncover = -(-s.pos // self.page_size)
        ps = s.n_indexed
        if req.out_tokens:
            parked = self.pool.park(s.pages[ps:ncover])
            self._preempted[req.uid] = {
                "slots": parked, "page0": ps, "pos": s.pos,
                "last_tok": s.last_tok}
            if parked is not None:
                self._stats["preempt_pages_parked"] += len(parked)
                self.pool.release(s.pages[:ps] + s.pages[ncover:])
            else:
                self.pool.release(s.pages)  # the record alone re-prefills
        else:
            # nothing generated yet: a plain requeue (its prompt pages stay
            # cached for the re-prefill)
            self.pool.release(s.pages)
        self.slots[b] = None
        self.queue.appendleft(req)
        self._stats["preemptions"] += 1
        return self._apply_pool_events(state)

    # -- deadlines / fault injection --------------------------------------
    def _expire_deadlines(self) -> None:
        """Abort every queued or live request whose deadline tick has
        passed, with a typed ``DeadlineExceeded`` carrying its partial
        output; a parked request's park is dropped."""
        tick = self._stats["ticks"]

        def expire(req: Request) -> None:
            req.error = DeadlineExceeded(
                f"request {req.uid} missed its deadline "
                f"(tick {tick} >= {req.deadline_tick})",
                tokens=req.out_tokens)
            req.done = True
            self._stats["deadline_expired"] += 1

        for req in [r for r in self.queue
                    if r.deadline_tick is not None
                    and tick >= r.deadline_tick]:
            self.queue.remove(req)
            self._drop_park_record(req.uid)
            expire(req)
        for b, s in enumerate(self.slots):
            if (s is not None and s.req.deadline_tick is not None
                    and tick >= s.req.deadline_tick):
                self._release_slot(b)
                expire(s.req)

    def _chaos_tick(self) -> bool:
        """Draw and apply this tick's injected faults (a pure function of
        the injector's seed and the tick).  Returns True for a stalled
        tick: nothing runs, the clock advances."""
        live = ([s.req.uid for s in self.slots if s is not None]
                + [r.uid for r in self.queue])
        f = self.fault_injector.faults(self._stats["ticks"], live)
        if f.get("cancel") is not None:
            if self.cancel(f["cancel"], error=Cancelled(
                    f"request {f['cancel']} cancelled by fault injection")):
                self._stats["chaos_cancels"] += 1
        if f.get("evict_storm"):
            self.pool.storm_host_cache()
            self._state = self._apply_pool_events(self._state)
            self._stats["chaos_evict_storms"] += 1
        if f.get("alloc_fail"):
            self._chaos_alloc_fail = True
            self._stats["chaos_alloc_fails"] += 1
        if f.get("stall"):
            self._stats["chaos_stalled_ticks"] += 1
            return True
        return False

    # -- slot lifecycle ---------------------------------------------------
    def _release_slot(self, b: int) -> None:
        s = self.slots[b]
        self.pool.release(s.pages)
        self.slots[b] = None

    def _index_filled_pages(self, s: _Slot) -> None:
        """Insert this slot's freshly completed PROMPT pages into the trie
        (decode tokens never advance ``fill``, and a re-prefilled history
        is indexed only as far as the prompt); stop when an equivalent page
        already owns the prefix."""
        if s.node is None or not self.prefix_cache:
            return
        P = self.page_size
        limit = min(s.fill, len(s.req.prompt))
        while (s.n_indexed + 1) * P <= limit:
            j = s.n_indexed
            key = tuple(int(t) for t in s.req.prompt[j * P:(j + 1) * P])
            s.node = self.pool.index_page(s.node, key, s.pages[j])
            if s.node is None:
                return
            s.n_indexed += 1

    # -- sampling / bookkeeping -------------------------------------------
    def _sample(self, req: Request, logits_row: np.ndarray,
                ordinal: int) -> int:
        """One token from a (V,) logits row: greedy argmax at temperature 0,
        seeded temperature/top-k sampling otherwise, keyed per (request
        seed, ``ordinal``) so the draw never depends on packing."""
        if req.temperature == 0.0:
            return int(np.argmax(logits_row))
        logit = logits_row.astype(np.float64) / req.temperature
        if req.top_k is not None and req.top_k < logit.size:
            kth = np.partition(logit, -req.top_k)[-req.top_k]
            logit = np.where(logit >= kth, logit, -np.inf)
        logit = logit - logit.max()
        p = np.exp(logit)
        p /= p.sum()
        base = req.seed if req.seed is not None else req.uid
        rng = np.random.default_rng((base, ordinal))
        return int(rng.choice(logit.size, p=p))

    def _finish_token(self, b: int, tok: int, results: Dict) -> None:
        """Book one sampled token for slot ``b``: emit, advance, retire the
        request (releasing its page refs) on EOS / max_tokens."""
        s = self.slots[b]
        req = s.req
        req.out_tokens.append(tok)
        s.pos += 1
        self.token_log.append((req.uid, self._stats["ticks"],
                               time.perf_counter()))
        if (len(req.out_tokens) >= req.max_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            req.done = True
            results[req.uid] = req.out_tokens
            self.completion_order.append(req.uid)
            self._release_slot(b)
        else:
            s.last_tok = tok

    # -- ragged path ------------------------------------------------------
    def _ragged_tick(self, state):
        """Pack one token budget and run the ragged step on it, then sample
        every slot that emits a token."""
        arrays, n, sampling, drafted = self._pack_ragged()
        results: Dict[int, List[int]] = {}
        if n == 0:
            return state, results
        self._run_step(self._ragged_step, arrays)
        self._stats["traces"] = 1  # JAX traces its step at the first call
        self._stats["ragged_ticks"] += 1
        self._stats["packed_tokens"] += n
        if not sampling:
            return state, results
        rows = self._ragged_step.fetch()  # (B, V), speculative (B, R, V)
        self._stats["sampled_slot_ticks"] += len(sampling)
        accepted: Dict[int, int] = {}
        for b in sampling:
            req = self.slots[b].req
            drafts = drafted.get(b, ())
            # row j is the prediction given drafts 1..j: sampling it checks
            # draft j+1 and, on a mismatch or past the chain, is the
            # correction or bonus token, so a slot emits at least one
            j = 0
            tok = self._sample(req, rows[b, 0] if self._spec_k else rows[b],
                               len(req.out_tokens))
            while True:
                self._finish_token(b, tok, results)
                if (self.slots[b] is None or j >= len(drafts)
                        or tok != drafts[j]):
                    break
                j += 1
                self._stats["spec_accepted"] += 1
                tok = self._sample(req, rows[b, j], len(req.out_tokens))
            accepted[b] = j
        if drafted:
            self._roll_back(drafted, accepted)
        return state, results

    def _roll_back(self, drafted: Dict[int, List[int]],
                   accepted: Dict[int, int]) -> None:
        """Kill the rows of rejected draft tails: ``kpos``/``slen`` at and
        past each live slot's new write position.  A released slot needs
        none: admission's reset rewrites its whole row."""
        mask = np.zeros(self.B, bool)
        new_len = np.zeros(self.B, np.int32)
        for b, d in drafted.items():
            j = accepted.get(b, 0)
            if j < len(d):
                self._stats["spec_rejected"] += len(d) - j
                s = self.slots[b]
                if s is not None:
                    mask[b] = True
                    new_len[b] = s.pos
        if mask.any():
            self._run_step(self._rollback, (mask, new_len))
            self._stats["spec_rollbacks"] += int(mask.sum())

    def _pack_ragged(self):
        """One token budget: decode tokens first, then prefill chunks until
        the budget runs out, each section in the scheduler's pack order
        (FIFO: slot order); a slot whose prefill completes in this pack
        appends its first decode token right behind it.  Slots whose
        ``ready_tick`` lies ahead sit this tick out.  With speculation, a
        third section: each slot that decoded from the start of the pack
        gets its draft chain in what budget is left (drafts never displace
        decode or prefill tokens).  Returns (the step's host arrays, tokens
        packed, slots to sample, {slot: drafted tokens})."""
        T, W = self.budget, self.width
        tokens = np.zeros(T, np.int32)
        slot = np.zeros(T, np.int32)
        q_pos = np.zeros(T, np.int32)
        seq_idx = np.full(T, W, np.int32)
        valid = np.zeros(T, bool)
        logit_idx = np.full((self.B, 1 + self._spec_k) if self._spec_k
                            else self.B, T, np.int32)
        sample_idx = logit_idx[:, 0] if self._spec_k else logit_idx  # a view
        n = 0
        sampling: List[int] = []
        tick = self._stats["ticks"]
        ready = [b for b, s in enumerate(self.slots)
                 if s is not None and s.ready_tick <= tick
                 and s.fill >= len(s.prefill_tokens)]
        filling = [b for b, s in enumerate(self.slots)
                   if s is not None and s.ready_tick <= tick
                   and s.fill < len(s.prefill_tokens)]
        if not self._default_pack:
            view = self._view(include_queue=False)
            ready = self._pack_order(
                self.scheduler.decode_order(view, ready), ready,
                "decode_order")
            filling = self._pack_order(
                self.scheduler.prefill_order(view, filling), filling,
                "prefill_order")
        for b in ready:
            s = self.slots[b]
            tokens[n], slot[n], q_pos[n] = s.last_tok, b, s.pos
            seq_idx[n], valid[n], sample_idx[b] = 0, True, n
            sampling.append(b)
            n += 1
        for b in filling:
            if n >= T:
                break
            s = self.slots[b]
            L = len(s.prefill_tokens)
            c = min(self.chunk, L - s.fill, T - n)
            tokens[n:n + c] = s.prefill_tokens[s.fill:s.fill + c]
            slot[n:n + c] = b
            q_pos[n:n + c] = s.fill + np.arange(c)
            seq_idx[n:n + c] = np.arange(c)
            valid[n:n + c] = True
            n += c
            s.fill += c
            self._index_filled_pages(s)
            if s.fill >= L:
                self._handoff(s, L)
                if n < T:
                    tokens[n], slot[n], q_pos[n] = s.last_tok, b, s.pos
                    seq_idx[n], valid[n], sample_idx[b] = c, True, n
                    sampling.append(b)
                    n += 1
        drafted: Dict[int, List[int]] = {}
        for b in ready if self._spec_k else ():
            if n >= T:
                break
            s = self.slots[b]
            req = s.req
            # no draft past max_tokens - 1 (it could never be accepted)
            room = min(self._spec_k,
                       req.max_tokens - len(req.out_tokens) - 1, T - n)
            if room < 1:
                continue
            hist = (np.concatenate([req.prompt, np.asarray(
                req.out_tokens, np.int32)]) if req.out_tokens else req.prompt)
            d = self._draft(hist, room)
            if not d:
                continue
            k = len(d)
            if __debug__:
                # draft rows land past the prompt, in pages the slot owns
                # alone: never in an indexed prefix page
                for pi in range((s.pos + 1) // self.page_size,
                                (s.pos + k) // self.page_size + 1):
                    assert not self.pool.is_indexed(s.pages[pi]), \
                        (b, pi, s.pages[pi])
            tokens[n:n + k] = d
            slot[n:n + k] = b
            q_pos[n:n + k] = s.pos + 1 + np.arange(k)
            seq_idx[n:n + k] = 1 + np.arange(k)
            valid[n:n + k] = True
            logit_idx[b, 1:1 + k] = n + np.arange(k)
            drafted[b] = d
            self._stats["spec_drafted"] += k
            n += k
        return ((tokens, slot, q_pos, seq_idx, valid, logit_idx), n,
                sampling, drafted)

    @staticmethod
    def _handoff(s: _Slot, L: int) -> None:
        """Prefill of ``L`` tokens is complete: decode resumes at position
        L from the last prefill token (as in JAX) or, for a re-prefilled
        preempted request, from its last generated token."""
        s.pos = L
        s.last_tok = (s.resume_tok if s.resume_tok is not None
                      else int(s.prefill_tokens[-1]))

    def _run_step(self, step: CapturedStep, arrays) -> None:
        """Run one step on a pack and count its kernel launches."""
        step.run(*arrays)
        self._stats["kernel_launches"] += step.launches

    # -- two-phase path (ragged=False) ------------------------------------
    def _prefill_tick(self, state):
        """Advance every slot with outstanding prompt tokens by one chunk —
        a single batched (B, chunk) step with per-slot positions."""
        self._run_step(self._chunk_step, self._pack_prefill())
        self._stats["chunk_ticks"] += 1
        return state

    def _pack_prefill(self):
        """The (B, chunk) prefill pack; advances each slot's fill."""
        C = self.chunk
        tokens = np.zeros((self.B, C), np.int32)
        q_pos = np.zeros((self.B, C), np.int32)
        valid = np.zeros((self.B, C), bool)
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            L = len(s.prefill_tokens)
            if s.fill >= L:
                continue
            n = min(C, L - s.fill)
            tokens[b, :n] = s.prefill_tokens[s.fill:s.fill + n]
            q_pos[b] = s.fill + np.arange(C)
            valid[b, :n] = True
            s.fill += n
            self._index_filled_pages(s)
            if s.fill >= L:
                self._handoff(s, L)
        return tokens, q_pos, valid

    def _decode_tick(self, state):
        """One decode token for every live slot — a (B, 1) step; idle slots
        ride along invalid (their kernel rows read stale pages, clamped into
        the pool, and are ignored)."""
        self._run_step(self._decode_step, self._pack_decode())
        rows = self._decode_step.fetch()  # (B, V) float32
        self._stats["decode_ticks"] += 1
        results: Dict[int, List[int]] = {}
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            self._finish_token(b, self._sample(s.req, rows[b],
                                               len(s.req.out_tokens)),
                               results)
        return state, results

    def _pack_decode(self):
        """The (B, 1) decode pack of every live slot."""
        tokens = np.zeros((self.B, 1), np.int32)
        q_pos = np.zeros((self.B, 1), np.int32)
        valid = np.zeros((self.B, 1), bool)
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            tokens[b, 0] = s.last_tok
            q_pos[b, 0] = s.pos
            valid[b, 0] = True
        return tokens, q_pos, valid

    # -- driving ----------------------------------------------------------
    @property
    def idle(self) -> bool:
        """No live slot and nothing queued."""
        return all(s is None for s in self.slots) and not self.queue

    def _ensure_state(self):
        """Decode state is created once and persists for the engine's whole
        life (the pool's pages ARE the prefix cache).  Windowed layers'
        buffers hold ``prefill_chunk`` entries past the window, as in JAX.
        The reset template holds what admission restores from it: a
        windowed layer's k/v buffers and a recurrent layer's states, each
        fresh value kept as a number (``model.reset_template``: 0, and
        -1e30 for the sLSTM stabilizer; ``transformer.reset_stage_slots``
        fills the admitted slots in place); block tables, ``kpos`` and
        ``slen`` are set from the admission itself and the pools are never
        reset.  The host tier's store is allocated beside it: one tensor
        per paged leaf, a row per host slot, pinned on a CUDA device (a
        failed pinned allocation raises; nothing falls back to pageable
        memory).  The steps of the
        engine's path are built (and, on a CUDA device, captured) here,
        once, over that state."""
        if self._state is None:
            self._state = M.init_paged_state(
                self.params, self.cfg, self.B, self.cache_len,
                page_size=self.page_size, n_pages=self.n_pages,
                window_extra=self.chunk, kv_dtype=self.kv_dtype)
            self._template = M.reset_template(self._state)
            if self.host_pages:
                pin = self.device.type == "cuda"
                self._host_store = {
                    key: torch.empty((self.host_pages,) + rows.shape,
                                     dtype=rows.dtype, pin_memory=pin)
                    for key, rows in self._gather_page(self._state, 0).items()}
            self._build_steps()

    def _build_steps(self) -> None:
        kw = dict(flash_decode=self.flash_decode, capture=self.cuda_graph)
        args = (self.cfg, self.params, self._state)
        if self.ragged:
            self._ragged_step = capture_ragged_step(
                *args, T=self.budget, B=self.B, width=self.width,
                R=1 + self._spec_k, **kw)
            steps = [self._ragged_step]
            if self._spec_k:
                self._rollback = capture_spec_rollback(
                    self.cfg, self._state, B=self.B, device=self.device,
                    capture=self.cuda_graph)
                steps.append(self._rollback)
        else:
            self._chunk_step = capture_paged_step(
                *args, B=self.B, C=self.chunk, with_logits=False, **kw)
            self._decode_step = capture_paged_step(
                *args, B=self.B, C=1, with_logits=True, **kw)
            steps = [self._chunk_step, self._decode_step]
        self._stats["graph_captures"] += sum(s.captured for s in steps)

    def tick(self) -> Dict[int, List[int]]:
        """One scheduling tick: expire deadlines, draw injected faults,
        admit (and preempt) from the queue, pack, run one step.  Returns
        the requests that finished this tick ({uid: tokens})."""
        self._ensure_state()
        self._expire_deadlines()
        self._chaos_alloc_fail = False
        if self.fault_injector is not None and self._chaos_tick():
            self._stats["ticks"] += 1  # stalled: the clock advanced
            self.tick_log.append((False, time.perf_counter()))
            return {}
        if self.pool.events:
            # expiry or cancellation dropped parks with no admission round
            # behind them to drain the hevicts
            self._state = self._apply_pool_events(self._state)
        self._state = self._admit(self._state)
        had_prefill = any(s is not None and s.fill < len(s.prefill_tokens)
                          for s in self.slots)
        results: Dict[int, List[int]] = {}
        if self.ragged:
            self._state, results = self._ragged_tick(self._state)
        elif had_prefill:
            self._state = self._prefill_tick(self._state)
        elif any(s is not None for s in self.slots):
            self._state, results = self._decode_tick(self._state)
        self._stats["ticks"] += 1
        self.tick_log.append((had_prefill, time.perf_counter()))
        return results

    def run(self, max_ticks: int = 4096) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated tokens}."""
        results: Dict[int, List[int]] = {}
        for _ in range(max_ticks):
            if self.idle:
                break
            results.update(self.tick())
        # drain partials on tick-budget exhaustion, releasing slots/pages so
        # the engine stays reusable; never-admitted requests report their
        # (empty) partials too, so every submitted uid is in the result
        for b, s in enumerate(self.slots):
            if s is not None:
                s.req.done = True
                results[s.req.uid] = s.req.out_tokens
                self._release_slot(b)
        while self.queue:
            req = self.queue.popleft()
            self._drop_park_record(req.uid)
            req.done = True
            results[req.uid] = req.out_tokens
        return results
