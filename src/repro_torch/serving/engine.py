"""Continuous-batching serving engine with an ARAS-style multi-model
weight arena — PyTorch port of `repro.serving.engine` for both KV
layouts: whole-sequence slots (`KVArena`, the default) and pages
(`PagedKVArena`).

Each step picks the tenants that run (all tenants with demand when their
layers fit the weight arena together, else one tenant per turn of
`model_turn_steps` steps), makes their weights resident — at once
(`WeightResidencyManager.ensure`) or through the budgeted install pipeline
that can overlap the next tenant's installs with the current one's last
decode steps — then admits up to `max_prefill_per_step` queued requests of
the resident tenants (a monolithic prefill, into a `max_seq` cache that
is written into the request's slot, or into a page-multiple bucket whose
pages are installed into the tenant's page pool; the prefill's logits
give the first token), then decodes one token for every running row of
each of them in one batched decode step, sampling on the device (fused,
paged tenants) or right after it (split: slot tenants always, as in the
reference).  With `prefill_chunk > 0` a prompt is instead prefilled in
chunks spread across steps under the scheduler's prefill-token budget:
each request stages its K/V in a contiguous staging cache (chunk
attention is the reference's masked einsum over it), skips the chunks a
paged tenant's prefix cache already holds (the staging is seeded from the
cached pages), and when the last chunk gives the first token installs its
slot row (windowed layers ringed, int8 quantized) or only its non-shared
pages; the tail chunk is padded to a bucket-ladder rung, so the chunk
shapes stay few.  Finished requests donate their pages to the radix
prefix cache when the tenant has it on; a pool that runs dry mid-decode
preempts the request, which re-prefills its prompt plus generated tokens
on readmission; a freed slot keeps its stale rows, which the position
mask never admits.

Three observation planes ride along, as in the reference.  The wear plane
counts every weight-slot install's cell flips and pulses and every KV
page program per physical unit (`WearMap`) and prices them in joules
(`EnergyModel`).  `wear_aware > 0` steers installs and page allocation
toward cold units, and `fault_rate > 0` injects seeded stuck-at faults
that retire a slot or page for good (the engine remaps, so tokens do not
move).  The live-telemetry plane (windowed percentiles, SLO burn rates,
JSONL events), the flight recorder and the step watchdog only observe:
no scheduling decision reads them.

The weight arena is an accounting model, as in the reference: every
tenant's params stay on the device, and residency decides when a tenant
runs, never what it computes.  For dense GQA tenants of either layout the
greedy tokens, stall steps, install bytes and the wear, fault and
telemetry artifacts match the reference engine's (`kernel_backend="xla"`)
on the CPU; a greedy pick at a bf16 tie can part, since XLA sums a
batched bf16 product in another order than torch does.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.ft import Watchdog
from repro_torch.launch.steps import (cached_chunk_prefill_step,
                                      cached_prefill_step,
                                      cached_serve_step,
                                      cached_stage_install,
                                      cached_stage_quantize,
                                      fused_paged_serve_step,
                                      paged_serve_step, prefill_cache_info,
                                      sample_step)
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.model import init_cache
from repro_torch.serving.bucketing import (PrefillProgress, bucket_for,
                                           bucket_ladder)
from repro_torch.serving.faults import FaultModel
from repro_torch.serving.kv_arena import KVArena
from repro_torch.serving.metrics import EngineMetrics, StepRecord
from repro_torch.serving.paging import PagedKVArena
from repro_torch.serving.recorder import FlightRecorder
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.residency import (InstallPipeline,
                                           WeightResidencyManager)
from repro_torch.serving.sampling import request_key, sample_token
from repro_torch.serving.scheduler import SchedulerConfig, StepScheduler
from repro_torch.serving.telemetry import EngineTelemetry, TelemetryConfig
from repro_torch.serving.tracing import NULL_TRACER, Tracer
from repro_torch.serving.wear import WearMap
from repro_torch.sim.energy import EnergyModel
from repro_torch.streaming.plan import InstallCostModel

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineModel:
    """One tenant: a named (params, config) pair plus its KV budget.

    kv_layout picks the arena: "slot" binds each request to a whole
    `max_seq` sequence slot of `kv_slots`; "paged" stores KV in
    `page_size`-token pages, `n_pages` of them (0 → kv_slots ·
    ceil(max_seq / page_size)), `kv_slots` becoming the decode-batch row
    count and the per-request ceiling the whole pool.  `prefix_cache`
    (paged only) retains finished requests' pages in a radix tree
    (LRU-evicted on demand, capped at `prefix_cache_pages`, 0 =
    uncapped)."""
    name: str
    params: Any
    cfg: ModelConfig
    kv_slots: int = 4
    max_seq: int = 64
    kv_layout: str = "slot"          # "slot" | "paged"
    page_size: int = 8
    n_pages: int = 0
    prefix_cache: bool = False
    prefix_cache_pages: int = 0

    def __post_init__(self):
        if self.kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r} "
                             "(expected 'slot' or 'paged')")
        if self.prefix_cache and self.kv_layout != "paged":
            raise ValueError(
                f"{self.name}: prefix_cache needs kv_layout='paged' "
                "(slot arenas have no pages to retain)")


class ServingEngine:
    def __init__(self, models: Sequence[EngineModel], *,
                 sched: SchedulerConfig = SchedulerConfig(),
                 weight_arena_slots: Optional[int] = None,
                 reuse: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 install_ticks_per_step: int = 0,
                 overlap_installs: bool = False,
                 install_cost: Optional[InstallCostModel] = None,
                 prefill_chunk: int = 0,
                 bucket_growth: float = 2.0,
                 bucket_min: int = 8,
                 staging_growth: float = 2.0,
                 tracer: Optional[Tracer] = None,
                 energy_model: Optional[EnergyModel] = None,
                 wear_aware: float = 0.0,
                 fault_rate: float = 0.0,
                 fault_seed: int = 0,
                 fuse_sampling: bool = True,
                 telemetry: Optional[TelemetryConfig] = None,
                 recorder: Optional[FlightRecorder] = None,
                 stall_timeout_s: float = 0.0,
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
        # fuse_sampling keeps sampling inside a paged tenant's decode step
        # so logits never leave the device; False splits it back out
        # (still one batched sampler call per step).  Slot tenants always
        # sample split, as the reference's do
        self._fuse = bool(fuse_sampling)
        self.arenas: Dict[str, Any] = {}
        for m in models:
            if m.kv_layout == "paged":
                n_pages = m.n_pages or m.kv_slots * -(-m.max_seq
                                                      // m.page_size)
                self.arenas[m.name] = PagedKVArena(
                    m.cfg, m.kv_slots, n_pages, m.page_size,
                    prefix_cache=m.prefix_cache,
                    prefix_cache_pages=m.prefix_cache_pages,
                    device=self.device)
            else:
                self.arenas[m.name] = KVArena(m.cfg, m.kv_slots, m.max_seq,
                                              device=self.device)

        # The weight arena: every tenant's big tensors in one quantized
        # store on the engine's device; the default arena holds every
        # tenant's layers at once, so nothing ever switches
        self.residency = WeightResidencyManager(
            {m.name: (m.params, m.cfg) for m in models},
            weight_arena_slots if weight_arena_slots is not None
            else sum(m.cfg.n_layers for m in models),
            reuse=reuse, device=self.device)

        # Structured tracing: NULL_TRACER (no-op) when disabled; a shared
        # Tracer otherwise, injected into the scheduler and the arenas so
        # resource decisions land in the same trace as the component spans
        self.tracer: Any = tracer if tracer is not None else NULL_TRACER
        self.residency.tracer = self.tracer
        for arena in self._paged_arenas():
            arena.tracer = self.tracer
            arena.allocator.tracer = self.tracer
        self.scheduler = StepScheduler(sched)
        self.scheduler.tracer = self.tracer
        self.metrics = EngineMetrics()

        # Live telemetry plane (all observation-only — no scheduling
        # decision ever reads a telemetry value, so enabling any of it is
        # token-identical to defaults-off).  telemetry: streaming windowed
        # percentiles + SLO burn tracking, fed per step / per finished
        # request.  recorder: a bounded flight ring dumped on retirement /
        # SLO breach / stall / SIGUSR1 / crash.  stall_timeout_s > 0 arms
        # the watchdog around every step as a serving heartbeat.
        self.telemetry: Optional[EngineTelemetry] = (
            EngineTelemetry(telemetry, tracer=self.tracer)
            if telemetry is not None else None)
        self.recorder = recorder
        if recorder is not None:
            recorder.tracer = self.tracer
        self._retired_seen = 0          # retirement-delta dump trigger
        self._stall_timeout_s = float(stall_timeout_s)
        self.watchdog: Optional[Watchdog] = (
            Watchdog(self._stall_timeout_s, on_timeout=self._on_stall)
            if self._stall_timeout_s > 0 else None)

        # Wear telemetry: one WearPlane per physical write plane — the
        # weight arena's slots and each paged tenant's KV page pool —
        # injected into the leaf modules like the tracer, and priced in
        # joules through the energy model by `_wear_stats()`.
        self.energy_model = energy_model or EnergyModel()
        self.wear = WearMap()
        self.residency.wear = self.wear.add_plane(
            "weight", self.residency.arena_slots)
        self.residency.flip_hist = self.metrics.registry.histogram(
            "install_cell_flips")
        for name, arena in self.arenas.items():
            if isinstance(arena, PagedKVArena):
                # first=1: device page 0 is the scratch page and never
                # takes an accounted write
                arena.wear = self.wear.add_plane(
                    f"kv:{name}", arena.allocator.n_pages, first=1)

        # Hamun policy half: act on the wear the planes record.
        # wear_aware > 0 (True coerces to 1.0) blends the install victim
        # picker's delta cost with per-slot write pressure and switches
        # page allocation to coldest-page-first; 0 keeps FIFO + pure
        # min-delta placement bit for bit.  fault_rate > 0 arms seeded
        # stuck-at faults over both planes: a write that fails verify
        # retires its slot or page for good and the engine remaps —
        # faulted runs stay token-equivalent to fault-free ones.
        self._wear_weight = float(wear_aware)
        if self._wear_weight < 0:
            raise ValueError("wear_aware must be >= 0 (a blend weight)")
        if self._wear_weight > 0:
            self.residency.wear_weight = self._wear_weight
            for arena in self._paged_arenas():
                arena.allocator.enable_wear_aware(arena.wear)
        self.faults: Optional[FaultModel] = (
            FaultModel(fault_rate, fault_seed) if fault_rate else None)
        if self.faults is not None:
            self.residency.faults = self.faults
            for name, arena in self.arenas.items():
                if isinstance(arena, PagedKVArena):
                    arena.allocator.faults = self.faults
                    arena.allocator.fault_plane = f"kv:{name}"
        self.requests: Dict[int, Request] = {}
        self._clock = clock
        self._next_rid = 0
        self._step_no = 0
        self._wall_s = 0.0   # cumulative time spent inside step()

        # Install pipelining: install_ticks_per_step > 0 budgets weight-arena
        # installs (one tick = install_cost.bytes_per_tick wire bytes per
        # step, the DMA a step can hide); 0 keeps the instant ensure() at
        # the turn boundary.  overlap_installs additionally prefetches the
        # next turn holder's layers while the current one still decodes —
        # free slots mid-turn, the holder's own slots behind the execution
        # front on its final slice step.
        self.install_cost = install_cost or InstallCostModel()
        self._ticks_per_step = int(install_ticks_per_step)
        self._overlap = bool(overlap_installs)
        if self._overlap and self._ticks_per_step <= 0:
            raise ValueError("overlap_installs needs install_ticks_per_step "
                             "> 0 (unbudgeted installs have nothing to hide)")
        self.pipeline: Optional[InstallPipeline] = (
            InstallPipeline(self.residency, self.install_cost)
            if self._ticks_per_step > 0 else None)
        if self.pipeline is not None:
            self.pipeline.tracer = self.tracer

        # Chunked prefill: prefill_chunk > 0 splits every prompt into
        # chunk-sized pieces run across steps under the scheduler's
        # prefill-token budget (queued -> PREFILLING -> RUNNING), so a long
        # prompt never freezes concurrent decodes.  The tail chunk is
        # padded up to a geometric bucket-ladder rung (bucket_growth <= 1
        # disables the padding).  0 keeps the monolithic prefill.
        self._chunk = int(prefill_chunk)
        if self._chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = monolithic)")
        self._ladder: Optional[list] = None
        if self._chunk > 0 and bucket_growth > 1.0:
            self._ladder = bucket_ladder(min(bucket_min, self._chunk),
                                         self._chunk, bucket_growth)
        self._prefills: Dict[int, PrefillProgress] = {}
        self._staging_ladders: Dict[str, list] = {}
        if self._chunk > 0:
            for m in models:
                # Staging-length ladder: each in-flight prefill stages into
                # the smallest rung covering its prompt.  Rungs are
                # multiples of the chunk (bucket-padded tails always fit,
                # chunk starts stay aligned) and, for paged tenants, of the
                # page size (the install's per-page slices stay in
                # bounds).  staging_growth <= 1 collapses it to the single
                # max-capacity length.
                quantum = self._chunk
                if m.kv_layout == "paged":
                    quantum = math.lcm(self._chunk, m.page_size)
                cap = self._capacity(m.name)
                top = -(-cap // quantum) * quantum
                if staging_growth > 1.0 and top > quantum:
                    rungs = sorted({-(-r // quantum) * quantum for r in
                                    bucket_ladder(quantum, top,
                                                  staging_growth)})
                else:
                    rungs = [top]
                self._staging_ladders[m.name] = rungs

    def staging_len_for(self, name: str, n_tokens: int) -> int:
        """The staging-ladder rung an `n_tokens`-token prefill stages into
        (smallest rung covering it; rungs are chunk multiples, so the
        bucket-padded tail chunk always fits)."""
        return bucket_for(n_tokens, self._staging_ladders[name])

    def _paged_arenas(self):
        return [a for a in self.arenas.values()
                if isinstance(a, PagedKVArena)]

    # ------------------------------------------------------------ intake
    def _prefill_fn(self, name: str, prompt_len: int):
        """Monolithic prefill (prefill_chunk == 0): slot tenants prefill
        into a `max_seq` cache, the shape of an arena row; paged tenants
        into a page-multiple bucket so installs write whole pages."""
        m = self.models[name]
        arena = self.arenas[name]
        if isinstance(arena, PagedKVArena):
            bucket = arena.blocks_for(prompt_len) * arena.page_size
            return cached_prefill_step(m.cfg, bucket)
        return cached_prefill_step(m.cfg, m.max_seq)

    def _capacity(self, model: str) -> int:
        """Per-request token ceiling: max_seq for slot arenas, the whole
        page pool for paged ones."""
        arena = self.arenas[model]
        if isinstance(arena, PagedKVArena):
            return arena.max_tokens
        return self.models[model].max_seq

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
        if req.prompt_len + max_new_tokens > self._capacity(model):
            req.status = RequestStatus.REJECTED
            self.scheduler.rejected += 1
            self.tracer.request_phase(req.rid, "rejected", model=model)
            return req
        self.scheduler.submit(req)
        self.tracer.request_phase(req.rid, "queued", model=model)
        return req

    def preempt(self, rid: int) -> None:
        """Evict a running request's KV slot or pages and requeue it; its
        generated prefix is re-prefilled on readmission, so no tokens are
        lost.  A mid-prefill (chunked) request keeps its staging and resumes
        at the last completed chunk instead."""
        req = self.requests[rid]
        if req.status is RequestStatus.PREFILLING:
            self._preempt_prefill(req)
            return
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
        arena = self.arenas[req.model]
        pages = (len(arena.allocator.tables.get(req.rid, ()))
                 if isinstance(arena, PagedKVArena) else 0)
        st = self._prefills.get(req.rid)
        chunks = (-(-st.done // self._chunk)
                  if st is not None and self._chunk > 0 else 0)
        self.tracer.instant("requeue", rid=req.rid, reason=reason,
                            pages_held=pages, chunks_done=chunks)
        _log.info(
            "request %d (%s) requeued [%s]: timeline[%s] pages_held=%d "
            "chunks_done=%d generated=%d preemptions=%d", req.rid,
            req.model, reason, self.tracer.request_timeline(req.rid), pages,
            chunks, len(req.generated), req.preemptions)

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

    def _can_admit(self, req: Request) -> bool:
        """Slot tenants gate on a free slot only; paged tenants also on
        enough free pages for the request's non-shared blocks."""
        arena = self.arenas[req.model]
        if isinstance(arena, PagedKVArena):
            return arena.can_admit(req.serving_prompt())
        return True

    def _next_admits(self, allowed) -> list:
        """Queued requests of the scheduled (weight-resident) tenants that
        get a free slot or decode row (and, paged, enough free pages for
        their non-shared blocks) this step, popped from the queue."""
        free = {name: (arena.n_free if name in allowed else 0)
                for name, arena in self.arenas.items()}
        n_active = sum(len(a.active_slots()) for a in self.arenas.values())
        return self.scheduler.next_admits(free, n_active, self._can_admit)

    def _admit(self, allowed) -> tuple:
        """Admit queued requests (`_next_admits`).  Each admission runs its
        monolithic prefill (`_prefill_fn`), installs the cache into its
        slot or pages and emits the first token."""
        admits = self._next_admits(allowed)
        n_admitted = n_tokens = 0
        for req in admits:
            m = self.models[req.model]
            arena = self.arenas[req.model]
            prompt = req.serving_prompt()
            paged = isinstance(arena, PagedKVArena)
            slot = arena.alloc(req.rid, prompt) if paged else \
                arena.alloc(req.rid)
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
            logits, caches = self._prefill_fn(req.model, len(prompt))(
                m.params, tokens)
            tok = self._pick_token(req, logits[0])
            n_tokens += len(prompt)
            arena.install(slot, caches, tok, prompt if paged else len(prompt))
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

    def _sample_inputs(self, arena) -> tuple:
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
        arena = self.arenas[req.model]
        if isinstance(arena, PagedKVArena):
            # with the prefix cache on, the finished request donates its
            # prompt+generated pages into the radix tree instead of freeing
            # them
            arena.evict(req.slot, donate=req.prompt + tuple(req.generated))
        else:
            arena.evict(req.slot)
        req.slot = None
        req.status = RequestStatus.FINISHED
        req.finish_t = self._clock()
        self.tracer.request_phase(req.rid, "finished",
                                  n_generated=len(req.generated))
        self.metrics.record_finish(req)
        if self.telemetry is not None:
            self.telemetry.on_finish(req)

    # ------------------------------------------------- chunked prefill
    def _admit_staged(self, allowed) -> int:
        """Chunked-prefill admission: claim a slot or decode row and a
        staging cache, but run no model yet — chunks run under
        _pump_prefills' token budget.  A preempted mid-prefill request
        re-enters here with its PrefillProgress intact and resumes at the
        last completed chunk.

        Prefix-cache hit: when a paged tenant's radix tree covers a prefix
        of the prompt, the staging is seeded from the cached pages up to the
        covered token and `done` jumps there, so those tokens are never
        recomputed and cost no prefill budget.  The skip is capped at
        prompt_len - 1 (the final chunk must run: its logits give the
        first token).  Returns the prompt tokens served from cache."""
        admits = self._next_admits(allowed)
        hit_tokens = 0
        for req in admits:
            arena = self.arenas[req.model]
            prompt = req.serving_prompt()
            paged = isinstance(arena, PagedKVArena)
            row = arena.stage(req.rid, prompt) if paged else \
                arena.alloc(req.rid)
            if row is None:
                # an earlier admit this step took the row the pre-pop
                # check saw; head-of-queue retry next step
                self.scheduler.requeue(req)
                req.status = RequestStatus.QUEUED
                self._note_requeue(req, "staging row race")
                continue
            req.slot = row
            req.status = RequestStatus.PREFILLING
            self.tracer.request_phase(req.rid, "prefilling")
            st = self._prefills.get(req.rid)
            if st is None or st.tokens != prompt:
                # fresh prefill (or a decode-preempted request whose prompt
                # grew by its generated tokens): new staging from zeros,
                # sized to the smallest ladder rung covering the prompt
                m = self.models[req.model]
                slen = self.staging_len_for(req.model, len(prompt))
                st = PrefillProgress(
                    tokens=prompt, staging_len=slen,
                    caches=init_cache(m.cfg, 1, slen, staging=True,
                                      device=self.device))
                self._prefills[req.rid] = st
            if paged and arena.skip_ok:
                # skip to the exact covered token; a resumed prefill jumps
                # too when pages donated since its preemption extend the
                # cover past its completed chunks
                skip = min(arena.covered_tokens(req.rid, len(prompt)),
                           len(prompt) - 1)
                if skip > st.done:
                    st.caches = arena.load_prefix(req.rid, st.caches, skip)
                    hit_tokens += skip - st.done
                    st.skipped += skip - st.done
                    st.done = skip
        return hit_tokens

    def _run_chunk(self, req: Request, st: PrefillProgress) -> int:
        """Advance one chunk; returns valid tokens processed, or -1 when a
        paged tenant could not reserve the chunk's pages (the prefill is
        preempted, staging intact, and resumes once pages free up)."""
        m = self.models[req.model]
        arena = self.arenas[req.model]
        start = st.done
        remaining = len(st.tokens) - start
        size = min(self._chunk, remaining)
        if isinstance(arena, PagedKVArena) and not arena.grow(
                req.rid, arena.blocks_for(start + size)):
            self._preempt_prefill(req)
            return -1
        if remaining > self._chunk:
            padded = self._chunk
        elif self._ladder is not None:
            padded = bucket_for(remaining, self._ladder)
        else:
            padded = remaining
        # a prefix-cache skip can start the tail chunk at an unaligned
        # position: clamp the padding so the write stays in the staging
        padded = min(padded, st.staging_len - start)
        buf = np.zeros((1, padded), np.int64)
        buf[0, :size] = st.tokens[start:start + size]
        if st.start_t is None:
            st.start_t = self._clock()
            if req.prefill_start_t is None:
                # a decode-preempted request re-prefilling keeps its first
                # stamp: the TTFT split describes the road to the FIRST
                # token only
                req.prefill_start_t = st.start_t
        step_fn = cached_chunk_prefill_step(m.cfg, padded, st.staging_len)
        logits, st.caches = step_fn(
            m.params, torch.from_numpy(buf).to(self.device), st.caches,
            start, size)
        st.done += size
        self.tracer.instant("prefill_chunk", rid=req.rid, start=start,
                            tokens=size)
        if st.finished:
            st.logits = logits
        return size

    def _finish_prefill(self, req: Request, st: PrefillProgress) -> None:
        """Last chunk done: install the staging cache into the arena (ring +
        slice + int8 quantization for a slot row; the non-shared blocks,
        int8 quantized, into a paged row's pages), emit the first token,
        and hand the request to the decode batch."""
        m = self.models[req.model]
        arena = self.arenas[req.model]
        tok = self._pick_token(req, st.logits[0])
        n_tok = len(st.tokens)
        if isinstance(arena, PagedKVArena):
            source = cached_stage_quantize(m.cfg, st.staging_len)(st.caches,
                                                                  n_tok)
            arena.finish_stage(req.slot, source, tok, st.tokens)
        else:
            row = cached_stage_install(m.cfg, st.staging_len, m.max_seq)(
                st.caches, n_tok)
            arena.install(req.slot, row, tok, n_tok)
        del self._prefills[req.rid]
        req.status = RequestStatus.RUNNING
        self.tracer.request_phase(req.rid, "running",
                                  tokens_skipped=st.skipped)
        req.generated.append(tok)
        req.note_token(self._clock())
        if req.first_token_t is None:
            req.first_token_t = self._clock()
        if req.done:
            self._finish(req)

    def _preempt_prefill(self, req: Request) -> None:
        """Mid-prefill preemption: release the slot or row and any reserved
        pages, keep the PrefillProgress (staging is per-request memory, not
        pool), and requeue at the head — readmission resumes at the last
        completed chunk."""
        self.arenas[req.model].evict(req.slot)
        req.slot = None
        req.preemptions += 1
        self.metrics.record_preemption()
        self.scheduler.requeue(req)
        self.tracer.request_phase(req.rid, "preempted")
        self._note_requeue(req, "prefill page exhaustion")

    def _pump_prefills(self, allowed) -> tuple:
        """One step of chunked-prefill work: admit queued requests into
        staging, then advance in-flight prefills (FIFO by rid) under the
        scheduler's prefill-token budget.  Returns (prefills completed,
        prompt tokens computed, chunks run, cache-hit tokens skipped) —
        hit tokens never touch the budget."""
        hit_tokens = self._admit_staged(allowed)
        budget = self.scheduler.prefill_token_budget()
        n_done = tokens = chunks = 0
        for rid in sorted(self._prefills):
            req = self.requests[rid]
            if (req.status is not RequestStatus.PREFILLING
                    or req.model not in allowed):
                continue
            while not self._prefills[rid].finished and tokens < budget:
                n = self._run_chunk(req, self._prefills[rid])
                if n < 0:
                    break
                tokens += n
                chunks += 1
            if (req.status is RequestStatus.PREFILLING
                    and self._prefills[rid].finished):
                self._finish_prefill(req, self._prefills[rid])
                n_done += 1
        return n_done, tokens, chunks, hit_tokens

    def _can_progress(self, name: str) -> bool:
        """A tenant runs this step only if it can generate tokens: it has
        active rows, or a queued request it could admit (free slot or row,
        global budget headroom, and for paged tenants enough pages)."""
        arena = self.arenas[name]
        if arena.active_slots():
            # includes PREFILLING rows: the tenant must be scheduled (and
            # weight-resident) for its chunks to advance
            return True
        if arena.n_free == 0:
            return False
        budget = self.scheduler.cfg.max_active
        if budget is not None:
            n_active = sum(len(a.active_slots())
                           for a in self.arenas.values())
            if n_active >= budget:
                return False
        return any(r.model == name and self._can_admit(r)
                   for r in self.scheduler.queue)

    def _pump_installs(self, run_models, demand) -> tuple:
        """Budgeted install path: grant this step's tick budget to the
        install pipeline.  Returns (decodable tenants, wire bytes committed,
        wire bytes of install stream processed)."""
        decodable = [n for n in run_models if self.residency.is_resident(n)]
        blocked = [n for n in run_models if n not in decodable]
        for name in decodable:
            self.residency.touch(name, self._step_no)
        target = blocked[0] if blocked else None
        if target is None and self._overlap:
            # the turn schedule names the next tenant: prefetch its layers
            # while the current holder still decodes
            nxt = self.scheduler.peek_next_model(demand)
            if (nxt is not None and nxt not in run_models
                    and not self.residency.is_resident(nxt)):
                target = nxt
        if target is None:
            return decodable, 0, 0
        self.pipeline.begin(target, self._step_no)
        pinned = set(decodable) | {target}
        holder = self.scheduler.current_turn_model
        if (self.scheduler.turn_ending and holder is not None
                and holder != target and self._steal_ok(target)):
            # the holder's final slice step: its slots free up behind the
            # execution front, so installs may overwrite them mid-step —
            # streaming/executor.py's per-layer overlap at the tenant scale
            pinned.discard(holder)
        wire, work = self.pipeline.pump(self._ticks_per_step, pinned,
                                        self._step_no)
        return decodable, wire, work

    def _steal_ok(self, target: str) -> bool:
        """Steal the ending turn holder's slots only when the prefetch
        target can actually take the next turn: it already decodes, or the
        global active budget leaves admission headroom even after this
        step's prefills.  A queued-only target behind an exhausted budget
        may drop out of demand next step — stealing for it would hand the
        turn straight back to the tenant whose layers we just evicted."""
        if self.arenas[target].active_slots():
            return True
        budget = self.scheduler.cfg.max_active
        if budget is None:
            return True
        n_active = sum(len(a.active_slots()) for a in self.arenas.values())
        return (n_active + self.scheduler.cfg.max_prefill_per_step) < budget

    def step(self) -> None:
        """One engine step: pick the scheduled tenants (by demand — active
        rows or admissible queued requests), make their weights resident
        (instantly, or via the budgeted install pipeline), admit+prefill
        their queued requests, then decode one token for every running
        row.

        With `stall_timeout_s > 0` the step runs under the watchdog: a step
        that overruns the deadline fires `_on_stall` (trace instant +
        flight-recorder dump) while the step keeps running — the heartbeat
        observes, it never kills work."""
        if self.watchdog is None:
            self._step_inner()
            return
        with self.watchdog.armed(self._step_no):
            self._step_inner()

    def _step_inner(self) -> None:
        now = self._clock()
        with self.tracer.span("schedule"):
            demand = [name for name in self.models
                      if self._can_progress(name)]
            run_models = self.scheduler.pick_models(demand, self.residency)
        wire = work = 0
        with self.tracer.span("install"):
            if self.pipeline is None:
                for name in run_models:
                    wire += self.residency.ensure(name, self._step_no,
                                                  pinned=set(run_models))
                decodable = list(run_models)
            else:
                decodable, wire, work = self._pump_installs(run_models,
                                                            demand)
        with self.tracer.span("prefill"):
            if self._chunk > 0:
                n_prefills, prefill_tokens, n_chunks, hit_tokens = (
                    self._pump_prefills(set(decodable)))
            else:
                n_prefills, prefill_tokens = self._admit(set(decodable))
                n_chunks = hit_tokens = 0

        n_decoded = sample_syncs = 0
        for name in decodable:
            m = self.models[name]
            arena = self.arenas[name]
            paged = isinstance(arena, PagedKVArena)

            def decoding(slot) -> bool:
                # PREFILLING rows hold a slot (and reserved pages) but are
                # not in the decode batch yet: the batched step still
                # computes their row, whose write lands in the scratch page
                # (paged) or is overwritten by the install (slot) and whose
                # output is discarded here
                s = self.requests[arena.owner_of(slot)].status
                return s is RequestStatus.RUNNING

            if paged:
                # extend tables across page boundaries and COW shared pages
                # before the step writes; pool exhaustion preempts (the
                # request re-prefills once pages free up)
                with self.tracer.span("page", tenant=name):
                    for slot in arena.active_slots():
                        if decoding(slot) and not arena.prepare_decode(slot):
                            self.preempt(arena.owner_of(slot))
            slots = [s for s in arena.active_slots() if decoding(s)]
            if not slots:
                continue
            fused = self._fuse and paged
            temps, tks, keys, steps = self._sample_inputs(arena)
            with self.tracer.span("decode", tenant=name, n_slots=len(slots)):
                if fused:
                    tokens, pos, tables = arena.decode_inputs()
                    toks_dev, arena.caches = fused_paged_serve_step(
                        m.params, tokens, arena.caches, pos, tables,
                        temps, tks, keys, steps, m.cfg)
                elif paged:
                    tokens, pos, tables = arena.decode_inputs()
                    logits, arena.caches = paged_serve_step(
                        m.params, tokens, arena.caches, pos, tables, m.cfg)
                else:
                    tokens, pos = arena.decode_inputs()
                    logits, arena.caches = cached_serve_step(m.cfg)(
                        m.params, tokens, arena.caches, pos)
            with self.tracer.span("sample", tenant=name, fused=fused,
                                  n_slots=len(slots)):
                if not fused:
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
            tokens_out = n_decoded + n_prefills
            stall = (bool(run_models) and len(decodable) < len(run_models)
                     and tokens_out == 0 and prefill_tokens == 0
                     and hit_tokens == 0)
            if stall:
                # the step produced nothing because the scheduled tenant sat
                # waiting on installs — don't charge it a decode-slice step
                self.scheduler.refund_turn_step()
            paged_arenas = self._paged_arenas()
            kv_used = sum(a.allocator.n_used for a in paged_arenas)
            kv_total = sum(a.allocator.n_pages for a in paged_arenas)
            cached = sum(a.allocator.tree.n_cached for a in paged_arenas)
        if self.tracer.enabled:
            self.tracer.counter("kv_used_pages", kv_used)
            self.tracer.counter("queue_depth", self.scheduler.queue_depth)
            # wear telemetry tracks: cumulative flips and the current wear
            # spread, beside pool headroom and install backlog
            self.tracer.counter("install_flips",
                                self.residency.stats.cell_flips)
            self.tracer.counter("wear_gini_weight",
                                round(self.residency.wear.gini("flips"), 4))
            self.tracer.counter("kv_free_pages", kv_total - kv_used)
            self.tracer.counter("install_queue_depth",
                                self.pipeline.queue_depth
                                if self.pipeline is not None else 0)
        rec = StepRecord(
            t=now,
            n_active=sum(len(a.active_slots()) for a in self.arenas.values()),
            queue_depth=self.scheduler.queue_depth,
            n_prefills=n_prefills,
            n_decoded=n_decoded,
            install_wire_bytes=wire,
            kv_used_pages=kv_used,
            kv_total_pages=kv_total,
            install_work_bytes=work,
            overlap_hidden_bytes=work if tokens_out > 0 else 0,
            install_stall=stall,
            prefill_tokens=prefill_tokens,
            n_prefill_chunks=n_chunks,
            prefix_hit_tokens=hit_tokens,
            prefix_cached_pages=cached,
            sample_syncs=sample_syncs,
            component_s=self.tracer.step_components())
        self.metrics.record_step(rec)
        if self.telemetry is not None or self.recorder is not None:
            self._observe_step(rec, kv_total - kv_used)
        self._step_no += 1
        self._wall_s += self._clock() - now

    def _observe_step(self, rec: StepRecord, free_pages: int) -> None:
        """Feed the live-telemetry plane after a step: window updates,
        SLO transitions, the flight ring, and the two recorder triggers
        the engine itself detects (unit retirement, SLO breach)."""
        transitions = (self.telemetry.on_step(self._step_no, rec,
                                              free_pages)
                       if self.telemetry is not None else [])
        if self.recorder is None:
            return
        self.recorder.record_step(self._step_no, rec, self.health())
        retired = self.residency.stats.slots_retired + sum(
            a.allocator.pages_retired for a in self._paged_arenas())
        if retired > self._retired_seen:
            # a slot/page retirement happened this step: capture the steps
            # that led up to it (Hamun-style incident forensics)
            self._retired_seen = retired
            self.recorder.trigger("unit_retired", step=self._step_no,
                                  retired_total=retired)
        for kind, target, burn_s, burn_l in transitions:
            if kind == "slo_breach":
                self.recorder.trigger("slo_breach", step=self._step_no,
                                      target=target, burn_short=burn_s,
                                      burn_long=burn_l)

    def _on_stall(self, step: int) -> None:
        """Watchdog deadline missed: the step loop has been inside step
        `step` for more than `stall_timeout_s`.  Observation only — the
        step keeps running; the suspicion is flagged and the ring
        snapshotted, so a genuinely hung replica leaves forensics
        behind."""
        if self.tracer.enabled:
            self.tracer.instant("stall_suspected", step=step,
                                timeout_s=self._stall_timeout_s)
        if self.recorder is not None:
            self.recorder.trigger("stall_suspected", step=step,
                                  timeout_s=self._stall_timeout_s)

    def health(self) -> Dict[str, Any]:
        """Cheap live-health snapshot — the router-tier placement probe.

        Pure observation over already-tracked state (no device sync, no
        list walks over history), deterministic under `VirtualClock`: two
        identical runs give byte-identical `health()` JSON.  The
        `slo`/`windows` sections appear only when telemetry is on; the
        resource half is always there."""
        paged = self._paged_arenas()
        res = self.residency
        slots_free = sum(1 for i, s in enumerate(res.slots)
                         if s is None and i not in res.retired)
        now = self._clock()
        hit = self.metrics.prefix_hit_tokens
        covered = hit + self.metrics.prefill_tokens
        doc: Dict[str, Any] = {
            "t": now,
            "step": self._step_no,
            "queue_depth": self.scheduler.queue_depth,
            "queue_wait_s": self.scheduler.queue_wait(now),
            "n_active": sum(len(a.active_slots())
                            for a in self.arenas.values()),
            "kv_free_pages": sum(a.allocator.n_free for a in paged),
            "kv_total_pages": sum(a.allocator.n_pages for a in paged),
            "weight_slots_free": slots_free,
            "weight_slots_total": res.arena_slots,
            "slots_retired": res.stats.slots_retired,
            "pages_retired": sum(a.allocator.pages_retired for a in paged),
            "prefix_cached_pages": sum(a.allocator.tree.n_cached
                                       for a in paged),
            "prefix_hit_rate": hit / max(covered, 1),
            "install_backlog": (self.pipeline.queue_depth
                                if self.pipeline is not None else 0),
            "ok": True,
        }
        if self.telemetry is not None and self.telemetry.slo is not None:
            doc["ok"] = not self.telemetry.slo.any_breached
            doc["slo"] = self.telemetry.slo.status()
        if self.telemetry is not None:
            doc["windows"] = self.telemetry.snapshot_scope("_global")
        return doc

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
            chunks_before = self.metrics.prefill_tokens
            hits_before = self.metrics.prefix_hit_tokens
            ticks_before = self.pipeline.pumped_ticks if self.pipeline else 0
            self.step()
            progressed = (
                self.metrics.tokens_generated != before
                or self.metrics.prefill_tokens != chunks_before
                or self.metrics.prefix_hit_tokens != hits_before
                or (self.pipeline is not None
                    and self.pipeline.pumped_ticks != ticks_before))
            stall = 0 if progressed else stall + 1
            if stall > 3:
                raise RuntimeError(
                    "engine stalled: queued work but no admissible slots")
        return self.summary()

    def summary(self, wall_s: Optional[float] = None) -> Dict[str, float]:
        """Metrics over `wall_s` if given, else over the engine's cumulative
        in-step time — counters are lifetime totals."""
        return self.metrics.summary(
            self._wall_s if wall_s is None else wall_s,
            residency=self.residency.stats.as_dict(),
            rejected=self.scheduler.rejected,
            paging=self._paging_stats(),
            prefill_cache=prefill_cache_info() if self._chunk > 0 else None,
            wear=self._wear_stats())

    def _wear_stats(self) -> Dict[str, float]:
        """Write energy and wear spread: install pulses and KV page bytes
        priced through the energy model, Gini coefficients per plane
        family.  `wear_gini_kv` only appears once a paged tenant exists —
        a slot-arena engine has no KV write plane to speak of."""
        em = self.energy_model
        paged = self._paged_arenas()
        out = {
            "install_energy_j": em.weight_write_j(
                self.residency.stats.write_pulses),
            "kv_write_energy_j": em.kv_write_j(
                sum(a.kv_bytes_written for a in paged)),
            "wear_gini_weight": self.residency.wear.gini("flips"),
        }
        if paged:
            out["wear_gini_kv"] = self.wear.gini(prefix="kv:")
        # fault-degradation counters: units retired after a stuck-at fault
        # was survived (slots_retired rides in on the residency stats)
        pages_retired = sum(a.allocator.pages_retired for a in paged)
        out["pages_retired"] = float(pages_retired)
        out["faults_survived"] = float(
            self.residency.stats.slots_retired + pages_retired)
        return out

    def _paging_stats(self) -> Optional[Dict[str, float]]:
        """Paged-arena stats summed over tenants (None when every tenant is
        slot-managed).  Each shared-page hit is one page of KV the pool
        never had to store or prefill twice."""
        agg: Dict[str, float] = {}
        for arena in self._paged_arenas():
            for k, v in arena.stats().items():
                agg[k] = agg.get(k, 0.0) + v
        if not agg:
            return None
        agg["kv_page_occupancy"] = (
            agg["kv_pages_used"] / max(agg["kv_pages_total"], 1.0))
        agg["kv_pages_saved"] = agg["kv_shared_page_hits"]
        return agg
