"""Continuous-batching serving engine — PyTorch port of
`repro.serving.engine` for the paged KV layout.

Every tenant's weights stay resident on the device.  Each step admits up
to `max_prefill_per_step` queued requests (a monolithic prefill into a
page-multiple bucket, whose pages are then installed into the tenant's
`PagedKVArena`; the prefill's logits give the first token), then decodes
one token for every running row of each tenant in one batched paged
decode step, sampling on the device (fused) or right after it (split).
Finished requests donate their pages to the radix prefix cache when the
tenant has it on; a pool that runs dry mid-decode preempts the request,
which re-prefills its prompt plus generated tokens on readmission.

For dense GQA tenants the greedy tokens match the reference engine's
(`kernel_backend="xla"`) token for token on the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.steps import (fused_paged_serve_step,
                                      paged_serve_step, prefill_step,
                                      sample_step)
from repro_torch.nn.config import ModelConfig
from repro_torch.serving.metrics import EngineMetrics, StepRecord
from repro_torch.serving.paging import PagedKVArena
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.sampling import request_key, sample_token
from repro_torch.serving.scheduler import SchedulerConfig, StepScheduler
from repro_torch.serving.tracing import NULL_TRACER, Tracer

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineModel:
    """One tenant: a named (params, config) pair plus its paged KV budget:
    `kv_slots` decode rows and `n_pages` pages of `page_size` tokens
    (0 → kv_slots · ceil(max_seq / page_size)); a request may span up to
    the whole pool.  `prefix_cache` retains finished requests' pages in a
    radix tree (LRU-evicted on demand, capped at `prefix_cache_pages`,
    0 = uncapped)."""
    name: str
    params: Any
    cfg: ModelConfig
    kv_slots: int = 4
    max_seq: int = 64
    page_size: int = 8
    n_pages: int = 0
    prefix_cache: bool = False
    prefix_cache_pages: int = 0


class ServingEngine:
    def __init__(self, models: Sequence[EngineModel], *,
                 sched: SchedulerConfig = SchedulerConfig(),
                 clock: Callable[[], float] = time.perf_counter,
                 tracer: Optional[Tracer] = None,
                 fuse_sampling: bool = True,
                 device="cuda"):
        if not models:
            raise ValueError("need at least one tenant model")
        names = [m.name for m in models]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        for m in models:
            if m.cfg.is_encoder or m.cfg.input_mode != "tokens":
                raise ValueError(f"{m.name}: engine serves causal token LMs")
        self.device = resolve_device(device)
        self.models: Dict[str, EngineModel] = {m.name: m for m in models}
        # fuse_sampling keeps sampling inside the decode step so logits
        # never leave the device; False splits it back out (still one
        # batched sampler call per step)
        self._fuse = bool(fuse_sampling)
        self.arenas: Dict[str, PagedKVArena] = {}
        for m in models:
            n_pages = m.n_pages or m.kv_slots * -(-m.max_seq // m.page_size)
            self.arenas[m.name] = PagedKVArena(
                m.cfg, m.kv_slots, n_pages, m.page_size,
                prefix_cache=m.prefix_cache,
                prefix_cache_pages=m.prefix_cache_pages, device=self.device)

        # Structured tracing: NULL_TRACER (no-op) when disabled; a shared
        # Tracer otherwise, injected into the scheduler and the arenas so
        # resource decisions land in the same trace as the component spans
        self.tracer: Any = tracer if tracer is not None else NULL_TRACER
        for arena in self.arenas.values():
            arena.tracer = self.tracer
            arena.allocator.tracer = self.tracer
        self.scheduler = StepScheduler(sched)
        self.scheduler.tracer = self.tracer
        self.metrics = EngineMetrics()
        self.requests: Dict[int, Request] = {}
        self._clock = clock
        self._next_rid = 0
        self._step_no = 0
        self._wall_s = 0.0   # cumulative time spent inside step()

    # ------------------------------------------------------------ intake
    def submit(self, model: str, prompt: Sequence[int],
               max_new_tokens: int = 16,
               arrival_t: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               seed: Optional[int] = None) -> Request:
        if model not in self.models:
            raise KeyError(f"unknown tenant {model!r}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1: the prefill "
                             "itself produces the first token")
        req = Request(rid=self._next_rid, model=model,
                      prompt=tuple(int(t) for t in prompt),
                      max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, seed=seed,
                      arrival_t=self._clock() if arrival_t is None
                      else arrival_t)
        self._next_rid += 1
        self.requests[req.rid] = req
        if req.prompt_len + max_new_tokens > self.arenas[model].max_tokens:
            req.status = RequestStatus.REJECTED
            self.scheduler.rejected += 1
            self.tracer.request_phase(req.rid, "rejected", model=model)
            return req
        self.scheduler.submit(req)
        self.tracer.request_phase(req.rid, "queued", model=model)
        return req

    def preempt(self, rid: int) -> None:
        """Evict a running request's pages and requeue it; its generated
        prefix is re-prefilled on readmission, so no tokens are lost."""
        req = self.requests[rid]
        if req.status is not RequestStatus.RUNNING:
            return
        self.arenas[req.model].evict(req.slot)
        req.slot = None
        req.preemptions += 1
        self.metrics.record_preemption()
        self.scheduler.requeue(req)
        self.tracer.request_phase(req.rid, "preempted")
        self._note_requeue(req, "decode preemption")

    def _note_requeue(self, req: Request, reason: str) -> None:
        """One-line per-request timeline summary on preemption or
        admission-race requeue.  No-op when tracing is disabled."""
        if not self.tracer.enabled:
            return
        pages = len(self.arenas[req.model].allocator.tables.get(req.rid, ()))
        self.tracer.instant("requeue", rid=req.rid, reason=reason,
                            pages_held=pages)
        _log.info(
            "request %d (%s) requeued [%s]: timeline[%s] pages_held=%d "
            "generated=%d preemptions=%d", req.rid, req.model, reason,
            self.tracer.request_timeline(req.rid), pages,
            len(req.generated), req.preemptions)

    # ------------------------------------------------------------- step
    def _pick_token(self, req: Request, logits_row) -> int:
        """Next token for `req` from its row of logits: greedy argmax by
        default, seeded temperature/top-k sampling otherwise.  The sample
        index is the request's generated count, so re-prefills after
        preemption resample the exact same continuation."""
        vocab = self.models[req.model].cfg.vocab
        return sample_token(logits_row, vocab, temperature=req.temperature,
                            top_k=req.top_k,
                            key=request_key(req.seed, req.rid),
                            step=len(req.generated))

    def _admit(self, allowed) -> tuple:
        """Admit queued requests: a free decode row AND enough free pages
        for the request's non-shared blocks.  Each admission runs its
        monolithic prefill into a page-multiple bucket (so the install
        writes whole pages) and emits the first token."""
        free = {name: (arena.n_free if name in allowed else 0)
                for name, arena in self.arenas.items()}
        n_active = sum(len(a.active_slots()) for a in self.arenas.values())
        admits = self.scheduler.next_admits(
            free, n_active,
            lambda req: self.arenas[req.model].can_admit(
                req.serving_prompt()))
        n_admitted = n_tokens = 0
        for req in admits:
            m = self.models[req.model]
            arena = self.arenas[req.model]
            prompt = req.serving_prompt()
            slot = arena.alloc(req.rid, prompt)
            if slot is None:
                # an earlier admit this step consumed the pages the
                # pre-pop check saw; head-of-queue retry next step.  The
                # request never ran, so it stays QUEUED
                self.scheduler.requeue(req)
                req.status = RequestStatus.QUEUED
                self._note_requeue(req, "admission page race")
                continue
            self.tracer.request_phase(req.rid, "prefilling")
            if req.prefill_start_t is None:
                req.prefill_start_t = self._clock()
            tokens = torch.tensor([prompt], dtype=torch.int64,
                                  device=self.device)
            bucket = arena.blocks_for(len(prompt)) * arena.page_size
            logits, caches = prefill_step(m.params, tokens, m.cfg, bucket)
            tok = self._pick_token(req, logits[0])
            n_tokens += len(prompt)
            arena.install(slot, caches, tok, prompt)
            req.slot = slot
            req.status = RequestStatus.RUNNING
            self.tracer.request_phase(req.rid, "running")
            req.generated.append(tok)
            req.note_token(self._clock())
            if req.first_token_t is None:
                req.first_token_t = self._clock()
            if req.done:
                self._finish(req)
            n_admitted += 1
        return n_admitted, n_tokens

    def _sample_inputs(self, arena: PagedKVArena) -> tuple:
        """Per-row host sampler inputs over a tenant's whole decode batch.
        Inactive rows get temperature 0 (a greedy lane nobody reads)."""
        n_rows = len(arena.owner)
        temps = np.zeros(n_rows, np.float32)
        tks = np.zeros(n_rows, np.int32)
        keys = np.zeros((n_rows, 2), np.int64)
        steps = np.zeros(n_rows, np.int32)
        for slot in arena.active_slots():
            req = self.requests[arena.owner_of(slot)]
            temps[slot] = req.temperature
            tks[slot] = req.top_k
            keys[slot] = request_key(req.seed, req.rid)
            steps[slot] = len(req.generated)
        return temps, tks, keys, steps

    def _finish(self, req: Request) -> None:
        # with the prefix cache on, the finished request donates its
        # prompt+generated pages into the radix tree instead of freeing them
        self.arenas[req.model].evict(req.slot,
                                     donate=req.prompt + tuple(req.generated))
        req.slot = None
        req.status = RequestStatus.FINISHED
        req.finish_t = self._clock()
        self.tracer.request_phase(req.rid, "finished",
                                  n_generated=len(req.generated))
        self.metrics.record_finish(req)

    def _can_progress(self, name: str) -> bool:
        """A tenant runs this step only if it can generate tokens: it has
        active rows, or a queued request it could admit (free row, global
        budget headroom, enough pages)."""
        arena = self.arenas[name]
        if arena.active_slots():
            return True
        if arena.n_free == 0:
            return False
        budget = self.scheduler.cfg.max_active
        if budget is not None:
            n_active = sum(len(a.active_slots())
                           for a in self.arenas.values())
            if n_active >= budget:
                return False
        return any(r.model == name and arena.can_admit(r.serving_prompt())
                   for r in self.scheduler.queue)

    def step(self) -> None:
        """One engine step: admit+prefill queued requests of the tenants
        with demand, then decode one token for every running row."""
        now = self._clock()
        with self.tracer.span("schedule"):
            demand = [name for name in self.models
                      if self._can_progress(name)]
            run_models = self.scheduler.pick_models(demand, None)
        with self.tracer.span("prefill"):
            n_prefills, prefill_tokens = self._admit(set(run_models))

        n_decoded = sample_syncs = 0
        for name in run_models:
            m = self.models[name]
            arena = self.arenas[name]
            # extend tables across page boundaries and COW shared pages
            # before the step writes; pool exhaustion preempts (the request
            # re-prefills once pages free up)
            with self.tracer.span("page", tenant=name):
                for slot in arena.active_slots():
                    if not arena.prepare_decode(slot):
                        self.preempt(arena.owner_of(slot))
            slots = arena.active_slots()
            if not slots:
                continue
            temps, tks, keys, steps = self._sample_inputs(arena)
            tokens, pos, tables = arena.decode_inputs()
            with self.tracer.span("decode", tenant=name, n_slots=len(slots)):
                if self._fuse:
                    toks_dev, arena.caches = fused_paged_serve_step(
                        m.params, tokens, arena.caches, pos, tables,
                        temps, tks, keys, steps, m.cfg)
                else:
                    logits, arena.caches = paged_serve_step(
                        m.params, tokens, arena.caches, pos, tables, m.cfg)
            with self.tracer.span("sample", tenant=name, fused=self._fuse,
                                  n_slots=len(slots)):
                if not self._fuse:
                    toks_dev = sample_step(logits, m.cfg.vocab, temps, tks,
                                           keys, steps)
                nxt = toks_dev.cpu().numpy()   # the step's one host sync
                sample_syncs += 1
                for slot in slots:
                    req = self.requests[arena.owner_of(slot)]
                    tok = int(nxt[slot])
                    req.generated.append(tok)
                    req.note_token(self._clock())
                    arena.advance(slot, tok)
                    n_decoded += 1
                    if req.done:
                        self._finish(req)

        with self.tracer.span("bookkeep"):
            kv_used = sum(a.allocator.n_used for a in self.arenas.values())
            kv_total = sum(a.allocator.n_pages for a in self.arenas.values())
            cached = sum(a.allocator.tree.n_cached
                         for a in self.arenas.values())
        if self.tracer.enabled:
            self.tracer.counter("kv_used_pages", kv_used)
            self.tracer.counter("queue_depth", self.scheduler.queue_depth)
            self.tracer.counter("kv_free_pages", kv_total - kv_used)
        self.metrics.record_step(StepRecord(
            t=now,
            n_active=sum(len(a.active_slots()) for a in self.arenas.values()),
            queue_depth=self.scheduler.queue_depth,
            n_prefills=n_prefills,
            n_decoded=n_decoded,
            install_wire_bytes=0,
            kv_used_pages=kv_used,
            kv_total_pages=kv_total,
            prefill_tokens=prefill_tokens,
            prefix_cached_pages=cached,
            sample_syncs=sample_syncs,
            component_s=self.tracer.step_components()))
        self._step_no += 1
        self._wall_s += self._clock() - now

    # -------------------------------------------------------------- run
    def has_work(self) -> bool:
        return bool(self.scheduler.queue) or any(
            a.active_slots() for a in self.arenas.values())

    def run(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Drive steps until idle; returns the metrics summary."""
        stall = 0
        while self.has_work():
            if max_steps is not None and self._step_no >= max_steps:
                break
            before = self.metrics.tokens_generated
            self.step()
            stall = 0 if self.metrics.tokens_generated != before else stall + 1
            if stall > 3:
                raise RuntimeError(
                    "engine stalled: queued work but no admissible slots")
        return self.summary()

    def summary(self, wall_s: Optional[float] = None) -> Dict[str, float]:
        """Metrics over `wall_s` if given, else over the engine's cumulative
        in-step time — counters are lifetime totals."""
        return self.metrics.summary(
            self._wall_s if wall_s is None else wall_s,
            rejected=self.scheduler.rejected,
            paging=self._paging_stats())

    def _paging_stats(self) -> Dict[str, float]:
        """Paged-arena stats summed over tenants.  Each shared-page hit is
        one page of KV the pool never had to store or prefill twice."""
        agg: Dict[str, float] = {}
        for arena in self.arenas.values():
            for k, v in arena.stats().items():
                agg[k] = agg.get(k, 0.0) + v
        agg["kv_page_occupancy"] = (
            agg["kv_pages_used"] / max(agg["kv_pages_total"], 1.0))
        agg["kv_pages_saved"] = agg["kv_shared_page_hits"]
        return agg
