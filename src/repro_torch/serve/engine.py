"""ServeEngine — the continuous-batching serving engine, on PyTorch.

Counterpart of the ragged and two-phase paths of
``repro.serve.engine.ServeEngine``, with the same constructor signature,
request surface (``submit`` / ``cancel`` / ``tick`` / ``run`` / ``stats``)
and scheduling, so that greedy transcripts are token-identical to the JAX
engine's on the same weights:

- **Pack.** Each tick packs a fixed token budget ``T`` (``token_budget``):
  decode tokens first (a decoding slot emits every tick), then prefill
  chunks of at most ``prefill_chunk`` tokens per slot in the leftover
  budget; a slot whose prompt completes in the pack appends its first
  decode token right behind it.  One step (``serve_step.make_ragged_step``)
  runs the whole pack.
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
  byte budget (``kv_dtype``: float32 | bfloat16 | int8).
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
  capture).  ``stats["traces"]``
  counts what JAX counts, builds of the ragged step (1 on the ragged
  engine, 0 on the two-phase one); ``stats["graph_captures"]`` counts the
  captured graphs of either path (0 on the CPU).  After a capture the
  kernel wrappers' own counters no longer run, so
  ``stats["kernel_launches"]`` adds the launches recorded at capture for
  every replay.

Left for later slices, each raising ``NotImplementedError`` naming it:
the host-RAM tier (``host_pages>0``),
tensor parallelism (``mesh``), fault injection (``fault_injector``), the
reordering schedulers, and priority classes (``submit(priority>0)``),
which are the only traffic under which the JAX engine preempts — so
priority-0 transcripts need no preemption, and ``preempt`` is accepted for
the signature's sake and has no effect yet.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M
from repro_torch.models.transformer import POOL_LEAVES
from repro_torch.serve.errors import (DeadlineExceeded, EngineOverloaded,
                                      RequestTooLarge)
from repro_torch.serve.handle import Request, RequestHandle
from repro_torch.serve.pool import (KV_ITEMSIZE, PagePool, _PrefixNode,
                                    kv_bytes_per_token, kv_page_bytes)
from repro_torch.serve.scheduler import SpeculativeScheduler, make_scheduler
from repro_torch.serve.serve_step import (CapturedStep, capture_paged_step,
                                          capture_ragged_step,
                                          capture_spec_rollback)

__all__ = ["ServeEngine", "kv_page_bytes", "kv_bytes_per_token"]


def _later(feature: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet: it comes with the {slice_name} slice "
        "of the PyTorch port (ROADMAP.md, Queue 1)")


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
        if host_pages:
            raise _later("the host-RAM KV tier (host_pages > 0)", "tiered-KV")
        if mesh is not None:
            raise _later("tensor-parallel serving (mesh=)", "multi-GPU")
        if fault_injector is not None:
            raise _later("fault injection (fault_injector=)", "preemption/chaos")
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
        self.scheduler_name = self.scheduler.name
        # every layer is paged global attention (check_supported below), the
        # condition under which JAX lets a rollback undo a draft
        self._spec_k = int(getattr(self.scheduler, "spec_k", 0))
        self._draft = getattr(self.scheduler, "draft", None)
        self.device = resolve_device(device)
        M.check_supported(cfg)
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
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.pps = -(-cache_len // page_size)  # block-table width
        # every layer is paged global attention (check_supported), so the
        # prefix cache always applies
        self.prefix_cache = bool(prefix_cache)
        # the page budget is a BYTE budget: the same bytes the activation-
        # dtype pool would take, never below one full block table per slot
        base_pages = batch_size * self.pps
        if max_pages is not None:
            self.n_pages = max_pages
        else:
            ref = kv_page_bytes(cfg, page_size, cfg.dtype)
            act = kv_page_bytes(cfg, page_size, self.kv_dtype)
            self.n_pages = max(base_pages, base_pages * ref // max(act, 1))
        self.pool = PagePool(self.n_pages, page_size,
                             index_enabled=self.prefix_cache)
        self.queue: deque = deque()
        self.slots: List[Optional[_Slot]] = [None] * batch_size
        self._uid = 0
        self._state = None  # persistent: the pool doubles as the prefix cache
        page_bytes = kv_page_bytes(cfg, page_size, self.kv_dtype)
        # the JAX engine's keys; counters of features not ported yet stay 0
        self._stats = {"chunk_ticks": 0, "decode_ticks": 0, "ragged_ticks": 0,
                       "ticks": 0, "packed_tokens": 0, "traces": 0,
                       "pages_in_use_peak": 0, "admissions": 0,
                       "prefix_hits": 0, "prefix_tokens_reused": 0,
                       "cow_copies": 0, "cancelled": 0,
                       "host_hits": 0, "host_pages_promoted": 0,
                       "host_pool_pages": 0,
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
        ``int`` subclass carrying the uid).  ``deadline_ticks`` arms a
        completion deadline that many ticks from now (an expired request
        aborts with ``DeadlineExceeded``); a request that can never fit
        rejects with ``RequestTooLarge``; with ``max_queue=`` set, a submit
        to a full queue rejects with ``EngineOverloaded``."""
        if priority > 0:
            raise _later("priority classes (submit(priority>0)), with the "
                         "preemption they trigger,", "scheduler")
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
        dequeued; an admitted one frees its slot and drops its page
        references (shared prefix pages survive for siblings and the cache).
        Returns False for finished or unknown requests.  ``error`` marks an
        engine-initiated abort, raised by ``result()``/``tokens()``."""
        uid = int(handle_or_uid)
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
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

    @property
    def stats(self) -> Dict:
        """Engine counters merged with the pool's (read-only snapshot)."""
        return {**self._stats, **self.pool.stats}

    @property
    def reclaimable_pages(self) -> int:
        """Free pages plus refcount-0 cached pages; equals ``n_pages``
        whenever no request is live."""
        return self.pool.reclaimable_pages

    def drop_prefix_cache(self) -> int:
        """Discard every refcount-0 cached page.  Returns the number of
        pages returned to the free list."""
        return self.pool.drop_cache()

    def pool_tensors(self) -> List[torch.Tensor]:
        """Every KV pool tensor of the state (values and int8 scales)."""
        self._ensure_state()
        return [c[k] for ss in self._state["layers"] for c in ss
                for k in POOL_LEAVES if k in c]

    # -- admission --------------------------------------------------------
    def _pages_needed(self, req: Request, matched_pages: int = 0) -> int:
        """Pages the request must RESERVE: its full footprint minus the
        ``matched_pages`` shared prefix pages it maps instead."""
        total = -(-(len(req.prompt) + req.max_tokens) // self.page_size)
        return total - matched_pages

    def _admit_round(self, state):
        """Admit queued requests in FIFO order into free slots while the
        pages each actually needs — its unmatched suffix after the longest
        cached prefix — fit in free + evictable pages; stop at the first
        that does not (no mid-flight OOM).  A mid-page prefix match copies
        the page (COW) into one the request owns before it writes there."""
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
        for b in range(self.B):
            if self.slots[b] is not None or not self.queue:
                continue
            req = self.queue[0]
            node, mpages, matched, cow = self.pool.match_prefix(req.prompt)
            need = self._pages_needed(req, matched_pages=len(mpages))
            if cow is not None and need > self.pool.available(
                    mpages + [cow[0]]):
                cow = None  # pinning the COW source would leave the pool
                # short one page: forgo the partial-page reuse
            if need > self.pool.available(mpages):
                break  # stop at the first infeasible candidate
            self.queue.popleft()
            mpages = self.pool.acquire(mpages)  # +1 ref each
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
                      n_indexed=len(mpages))
            if matched >= len(req.prompt):
                # whole prompt cached: straight to decode from the last
                # prompt token at position L
                s.pos = len(req.prompt)
                s.last_tok = int(req.prompt[-1])
            self.slots[b] = s
            mask[b] = True
            self._stats["admissions"] += 1
            if matched:
                self._stats["prefix_hits"] += 1
                self._stats["prefix_tokens_reused"] += matched
        if mask.any():
            self._stats["pages_in_use_peak"] = max(
                self._stats["pages_in_use_peak"], self.pool.pages_in_use)
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

    # -- deadlines --------------------------------------------------------
    def _expire_deadlines(self) -> None:
        """Abort every queued or live request whose deadline tick has
        passed, with a typed ``DeadlineExceeded`` carrying its partial
        output."""
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
            expire(req)
        for b, s in enumerate(self.slots):
            if (s is not None and s.req.deadline_tick is not None
                    and tick >= s.req.deadline_tick):
                self._release_slot(b)
                expire(s.req)

    # -- slot lifecycle ---------------------------------------------------
    def _release_slot(self, b: int) -> None:
        s = self.slots[b]
        self.pool.release(s.pages)
        self.slots[b] = None

    def _index_filled_pages(self, s: _Slot) -> None:
        """Insert this slot's freshly completed PROMPT pages into the trie
        (decode tokens never advance ``fill``, so generated pages are never
        indexed); stop when an equivalent page already owns the prefix."""
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
        if (len(req.out_tokens) >= req.max_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            req.done = True
            results[req.uid] = req.out_tokens
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
        """One token budget: decode tokens first, then prefill chunks in
        slot order until the budget runs out; a slot whose prompt completes
        in this pack appends its first decode token right behind it.  With
        speculation, a third section: each slot that decoded from the start
        of the pack gets its draft chain in what budget is left (drafts
        never displace decode or prefill tokens).  Returns (the step's host
        arrays, tokens packed, slots to sample, {slot: drafted tokens})."""
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
        ready = [b for b, s in enumerate(self.slots)
                 if s is not None and s.fill >= len(s.req.prompt)]
        filling = [b for b, s in enumerate(self.slots)
                   if s is not None and s.fill < len(s.req.prompt)]
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
            L = len(s.req.prompt)
            c = min(self.chunk, L - s.fill, T - n)
            tokens[n:n + c] = s.req.prompt[s.fill:s.fill + c]
            slot[n:n + c] = b
            q_pos[n:n + c] = s.fill + np.arange(c)
            seq_idx[n:n + c] = np.arange(c)
            valid[n:n + c] = True
            n += c
            s.fill += c
            self._index_filled_pages(s)
            if s.fill >= L:
                # decode resumes from the last prompt token at position L
                s.pos = L
                s.last_tok = int(s.req.prompt[-1])
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
            L = len(s.req.prompt)
            if s.fill >= L:
                continue
            n = min(C, L - s.fill)
            tokens[b, :n] = s.req.prompt[s.fill:s.fill + n]
            q_pos[b] = s.fill + np.arange(C)
            valid[b, :n] = True
            s.fill += n
            self._index_filled_pages(s)
            if s.fill >= L:
                s.pos = L
                s.last_tok = int(s.req.prompt[-1])
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
        life (the pool's pages ARE the prefix cache).  The reset template
        holds fresh copies of the per-slot leaves only — it must not alias
        the live state, and the pools are never reset.  The steps of the
        engine's path are built (and, on a CUDA device, captured) here,
        once, over that state."""
        if self._state is None:
            self._state = M.init_paged_state(
                self.params, self.cfg, self.B, self.cache_len,
                page_size=self.page_size, n_pages=self.n_pages,
                kv_dtype=self.kv_dtype)
            self._template = {"layers": [
                [{k: v.clone() for k, v in c.items() if k not in POOL_LEAVES}
                 for c in ss] for ss in self._state["layers"]]}
            self._build_steps()

    def _build_steps(self) -> None:
        kw = dict(flash_decode=self.flash_decode, capture=self.cuda_graph)
        args = (self.cfg, self.params, self._state)
        if self.ragged:
            self._ragged_step = capture_ragged_step(
                *args, T=self.budget, B=self.B, width=self.width,
                R=1 + self._spec_k, **kw)
            self._stats["traces"] += 1
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
        """One scheduling tick: admit from the queue, pack, run one step.
        Returns the requests that finished this tick ({uid: tokens})."""
        self._ensure_state()
        self._expire_deadlines()
        self._state = self._admit_round(self._state)
        results: Dict[int, List[int]] = {}
        if self.ragged:
            self._state, results = self._ragged_tick(self._state)
        elif any(s is not None and s.fill < len(s.req.prompt)
                 for s in self.slots):
            self._state = self._prefill_tick(self._state)
        elif any(s is not None for s in self.slots):
            self._state, results = self._decode_tick(self._state)
        self._stats["ticks"] += 1
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
            req.done = True
            results[req.uid] = req.out_tokens
        return results
