"""Discrete-event RAG serving simulator.

Executes the *identical* controller / knowledge-tree / PGDSF / reorder /
speculative-pipelining code as the port's real engine, against an analytic
hardware profile (A10G, H800, TPU v5e) — paper-scale TTFT / throughput
claims without a card (a copy of ``repro.serving.simulator``).

Engine model (matches the paper's testbed semantics):
  * vector search runs on host CPUs, staged, one lane per request;
  * the LLM engine serves one iteration at a time: a chunked, ragged-batched
    prefill iteration (pieces of ``prefill_chunk`` tokens packed up to
    ``max_prefill_tokens``) or one decode step for the whole running batch;
  * prefill latency = host->GPU promotion transfer + T(alpha, beta),
    apportioned per chunk token;
  * a speculative prefill whose documents go stale is cancelled if still
    queued, and cancelled *between chunks* if running (the paper cancels
    "after the current iteration"); the remaining chunk tokens are saved.

The per-iteration decision (prefill vs decode, chunk packing, cache-aware
job pick) is NOT local code: it is the shared
``serving.scheduler.ContinuousBatchScheduler`` and its chunk protocol, the
same policy object the port's runtime (``serving.runtime``) executes, so
simulated and real scheduling cannot drift — including chunk boundaries,
which come from the shared ``prefill_piece_sizes`` splitter.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.controller import (RAGController, RequestPlan,
                                   effective_recompute)
from repro_torch.core.knowledge_tree import CacheBackend, KnowledgeTree
from repro_torch.core.profiler import CostProfiler, HardwareProfile
from repro_torch.core.speculative import SpecState, SpeculativeController
from repro_torch.retrieval.corpus import Corpus, Request
from repro_torch.serving.config import FleetConfig
from repro_torch.serving.router import AFFINITY, ReplicaRouter, partition_requests
from repro_torch.serving.scheduler import (DECODE, PREFILL,
                                     ContinuousBatchScheduler,
                                     SchedulerConfig, prefill_piece_sizes)


@dataclasses.dataclass
class SimConfig:
    profile: HardwareProfile
    gpu_cache_bytes: float = 8 * 2**30
    host_cache_bytes: float = 192 * 2**30
    disk_cache_bytes: float = 0.0  # third tier below host (0 = disabled)
    max_batch: int = 4
    max_prefill_bs: int = 4
    top_k: int = 2
    policy: str = "pgdsf"
    reorder: bool = True
    reorder_window: int = 32
    speculative: bool = True
    search_fraction: float = 1.0
    system_prompt_tokens: int = 0
    cache_top_k: int = 0           # paper §8 "Large top-k": cache only the
                                   # first k docs of each request's sequence
                                   # (0 = cache all retrieved docs)
    prefill_chunk: int = 512       # tokens per prefill iteration (vLLM-style
                                   # iteration-level scheduling; stale
                                   # speculation cancels between iterations)
    max_prefill_tokens: int = 0    # ragged prefill-batch token budget per
                                   # iteration (0 = one request per iteration)
    seed: int = 0                  # seeds the simulator's own RNG (a
                                   # ``random.Random`` instance — NO
                                   # module-level global state), so two runs
                                   # with the same config+workload produce
                                   # identical SimMetrics by construction
    latency_jitter: float = 0.0    # +/- fractional noise on engine
                                   # iteration times drawn from the seeded
                                   # RNG (real accelerators are not
                                   # constant-latency; 0 = analytic times)
    tp: int = 1                    # tensor-parallel degree of the replica:
                                   # service times come from
                                   # profile.with_tp(tp) (compute/bandwidth
                                   # scale by tp, each forward pays a ring
                                   # all-reduce term); mirrors serve.py --tp
    reuse: str = "prefix"          # "prefix" = longest-cached-prefix reuse;
                                   # "chunk" = per-doc chunk cache reused at
                                   # any position with boundary recompute
                                   # (docs/ARCHITECTURE.md §11)
    recompute_tokens: int = 16     # boundary rows recomputed per relocated
                                   # chunk (page-aligned up via
                                   # effective_recompute — same widths as
                                   # the real runtime)
    block_size: int = 16           # KV page size effective_recompute aligns
                                   # to; mirrors the runtime's paged pool
    mode: str = "rag"              # "rag" = staged retrieval per request;
                                   # "cag" = full corpus KV preloaded into
                                   # the disk tier at startup, zero
                                   # retrieval stages per request (mirrors
                                   # EngineConfig.mode; ARCHITECTURE §12)

    def __post_init__(self):
        if self.reuse not in ("prefix", "chunk"):
            raise ValueError(f"SimConfig.reuse must be 'prefix' or 'chunk', "
                             f"got {self.reuse!r}")
        if self.mode not in ("rag", "cag"):
            raise ValueError(f"SimConfig.mode must be 'rag' or 'cag', "
                             f"got {self.mode!r}")
        if self.mode == "cag" and self.disk_cache_bytes <= 0:
            raise ValueError("SimConfig.mode='cag' preloads the corpus into "
                             "the disk tier and needs disk_cache_bytes > 0")


@dataclasses.dataclass
class SimMetrics:
    avg_ttft: float
    p50_ttft: float
    p99_ttft: float
    avg_tpot: float                # paper §8: time per output token
    doc_hit_rate: float
    completed: int
    duration: float
    throughput_rps: float
    avg_non_overlap_search: float
    wasted_prefills: int
    gpu_evictions: int
    swap_out_bytes: int
    disk_evictions: int = 0
    spill_bytes: int = 0               # host->disk bytes written (once/node)
    fetch_bytes: int = 0               # disk->host bytes read on promotion
    hit_tokens_gpu: int = 0            # alpha tokens by residency tier at
    hit_tokens_host: int = 0           # plan time (three-clock PGDSF)
    hit_tokens_disk: int = 0
    chunks_cancelled: int = 0          # prefills aborted at a chunk boundary
    chunk_tokens_saved: int = 0        # prefill tokens never computed thanks
                                       # to mid-prefill cancellation
    prefill_iterations: int = 0
    avg_prefill_batch: float = 0.0     # chunks packed per prefill iteration
    retrieval_stages: int = 0          # staged-search events processed
                                       # (CAG invariant: exactly 0)
    ttfts: List[float] = dataclasses.field(default_factory=list, repr=False)
    # TTFTs of requests whose final plan hit at least one disk-resident
    # node — the tiered-cache benchmark's headline population
    disk_hit_ttfts: List[float] = dataclasses.field(default_factory=list,
                                                    repr=False)


class _SimBackend(CacheBackend):
    """Payloads are byte counts; GPU<->host hops cost PCIe time, host<->disk
    hops cost NVMe sequential-bandwidth time."""

    def __init__(self, profile: HardwareProfile):
        self.profile = profile

    def swap_out(self, node):
        node.payload_host = node.payload_gpu
        return self.profile.transfer_time(node.bytes_)

    def load(self, node):
        node.payload_gpu = node.payload_host
        return self.profile.transfer_time(node.bytes_)

    def spill(self, node):
        node.payload_disk = node.payload_host
        return self.profile.disk_transfer_time(node.bytes_)

    def fetch(self, node):
        node.payload_host = node.payload_disk
        return self.profile.disk_transfer_time(node.bytes_)


@dataclasses.dataclass
class _Job:
    req: "_ReqState"
    docs: Tuple[int, ...]
    speculative: bool
    cancelled: bool = False
    plan: Optional[RequestPlan] = None
    started: float = -1.0
    start_candidate: Optional[float] = None
    # chunked-prefill state (set when the first chunk executes)
    pending: List[int] = dataclasses.field(default_factory=list)
    sec_per_token: float = 0.0


@dataclasses.dataclass
class _ReqState:
    r: Request
    spec: SpecState
    stages: List = dataclasses.field(default_factory=list)
    search_start: float = 0.0
    search_end: float = -1.0
    final_docs: Optional[Tuple[int, ...]] = None
    final_prefill_first_start: float = -1.0   # for non-overlap metric
    prefill_done: float = -1.0
    prefill_docs: Optional[Tuple[int, ...]] = None
    ttft: float = -1.0
    remaining_out: int = 0
    context: int = 0
    # (gpu, host, disk) hit tokens of the final plan — per-request tier
    # attribution for the tiered-cache benchmark
    hit_tier_tokens: Tuple[int, int, int] = (0, 0, 0)
    done: bool = False
    finish_time: float = -1.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    queued_jobs: List[_Job] = dataclasses.field(default_factory=list)
    spec_start_by_docs: Dict[Tuple[int, ...], float] = dataclasses.field(
        default_factory=dict)


class RAGSimulator:
    def __init__(self, cfg: SimConfig, corpus: Corpus, index,
                 requests: Sequence[Request],
                 profiler: Optional[CostProfiler] = None):
        # TP-scaled service times: swap the profile for its with_tp()
        # derivative ONCE here so every consumer below (cost profiler,
        # backend transfer times, decode_time) sees the same scaled model
        if cfg.tp > 1:
            cfg = dataclasses.replace(cfg,
                                      profile=cfg.profile.with_tp(cfg.tp))
        self.cfg = cfg
        self.corpus = corpus
        self.index = index
        self.requests = list(requests)
        # instance-owned seeded RNG: every stochastic choice (currently the
        # optional latency jitter) draws from here, never from the
        # process-global ``random``/``np.random`` state — same-seed
        # determinism is a tested property (tests/test_simulator.py)
        self.rng = random.Random(cfg.seed)
        prof = profiler or CostProfiler.from_profile(cfg.profile)
        self.tree = KnowledgeTree(
            int(cfg.gpu_cache_bytes), int(cfg.host_cache_bytes),
            int(cfg.disk_cache_bytes),
            policy=cfg.policy, profiler=prof,
            backend=_SimBackend(cfg.profile),
            bytes_per_token=int(cfg.profile.kv_bytes_per_token),
        )
        self.controller = RAGController(self.tree)
        self.spec_ctl = SpeculativeController(cfg.max_prefill_bs,
                                              enabled=cfg.speculative)
        # shared iteration-level policy (same object type the real runtime
        # drives); simulation has no block pool, so admission is unbounded
        self.sched: ContinuousBatchScheduler[_Job] = ContinuousBatchScheduler(
            SchedulerConfig(max_batch=cfg.max_batch,
                            max_prefill_bs=cfg.max_prefill_bs,
                            reorder=cfg.reorder,
                            reorder_window=cfg.reorder_window,
                            prefill_chunk=cfg.prefill_chunk,
                            max_prefill_tokens=cfg.max_prefill_tokens),
            viable=lambda job: not job.cancelled and not job.req.done)
        self.queue = self.sched.queue
        self.decode_running: List[_ReqState] = []
        self.engine_busy = False
        self.now = 0.0
        self._events: List = []
        self._seq = itertools.count()
        self.sched_times: List[float] = []
        self._all_states: List[_ReqState] = []
        self._partial_jobs: List[_Job] = []
        self.chunks_cancelled = 0
        self.chunk_tokens_saved = 0
        self.prefill_batches: List[int] = []   # chunks packed per iteration
        self.retrieval_stages = 0
        # CAG startup: pre-insert every doc into the disk tier (payloads are
        # byte counts in the simulator) — same preload contract as the real
        # engines, so sim and runtime share the residency policy exactly
        self.preload_stats: Optional[dict] = None
        if cfg.mode == "cag":
            self.preload_stats = self.controller.preload_corpus(
                range(len(corpus.doc_lengths)), corpus.doc_lengths,
                lambda d, n_tok: n_tok * self.tree.bytes_per_token)

    # ---- event plumbing ---------------------------------------------------

    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _jitter(self) -> float:
        """Multiplicative iteration-time noise from the seeded RNG."""
        j = self.cfg.latency_jitter
        if j <= 0.0:
            return 1.0
        return 1.0 + j * (2.0 * self.rng.random() - 1.0)

    # ---- main loop --------------------------------------------------------

    def run(self) -> SimMetrics:
        for r in self.requests:
            self._push(r.arrival, "arrival", r)
        while self._events:
            self.now, _, kind, payload = heapq.heappop(self._events)
            getattr(self, f"_on_{kind}")(payload)
        return self._metrics()

    # ---- arrival & staged retrieval ----------------------------------------

    def _on_arrival(self, r: Request) -> None:
        st = _ReqState(r=r, spec=SpecState(r.req_id),
                       remaining_out=r.output_len, search_start=self.now)
        self._all_states.append(st)
        # per-request top_k override (Request.top_k > 0): the front door's
        # SLO admission degrades by lowering retrieval depth; the real
        # engines honor the same override, so miss tokens stay identical
        k = min(r.top_k, self.cfg.top_k) if r.top_k > 0 else self.cfg.top_k
        if self.cfg.mode == "cag":
            # CAG: every doc's KV is already tree-resident, so there is no
            # retrieval to overlap — resolve docs with ONE synchronous probe
            # and submit the final (non-speculative) job at arrival
            docs = tuple(int(d) for d in self.index.search(r.query_vec, k))
            st.search_end = self.now
            st.final_docs = docs
            job = _Job(req=st, docs=docs, speculative=False)
            st.queued_jobs.append(job)
            plan_docs = [self.corpus.doc_lengths[i] for i in docs]
            cached = self._cached_tokens(docs, plan_docs)
            compute = sum(plan_docs) + len(r.question_tokens) - cached
            self.sched.submit(job, cached, compute)
            self._engine_maybe_start()
            return
        st.stages = list(self.index.staged_search(
            r.query_vec, k, self.cfg.search_fraction))
        t = self.now
        for stage in st.stages:
            t += stage.seconds
            self._push(t, "stage", (st, stage))

    def _pool_size(self) -> int:
        return self.sched.pool_size()

    def _on_stage(self, payload) -> None:
        st, stage = payload
        self.retrieval_stages += 1
        docs = tuple(stage.topk)
        if stage.is_final:
            st.search_end = self.now
            st.final_docs = docs
        import time as _t
        t0 = _t.perf_counter()
        action, d = self.spec_ctl.on_stage(
            st.spec, docs, self._pool_size(), is_final=stage.is_final)
        if action in ("terminate_and_launch", "terminate"):
            for job in st.queued_jobs:
                if not job.cancelled and job.docs != docs:
                    job.cancelled = True
        if action in ("launch", "terminate_and_launch"):
            job = _Job(req=st, docs=d, speculative=not stage.is_final)
            st.queued_jobs.append(job)
            # cached/compute lengths for cache-aware reordering
            plan_docs = [self.corpus.doc_lengths[i] for i in d]
            cached = self._cached_tokens(d, plan_docs)
            compute = sum(plan_docs) + len(st.r.question_tokens) - cached
            self.sched.submit(job, cached, compute)
        self.sched_times.append(_t.perf_counter() - t0)
        if stage.is_final:
            self._maybe_finalize(st)
        self._engine_maybe_start()

    def _maybe_finalize(self, st: _ReqState) -> None:
        """Search finished: if a matching prefill already completed, emit the
        first token now (speculation pays off — paper Fig. 11)."""
        if st.ttft >= 0 or st.done:
            return
        if st.prefill_docs == st.final_docs and st.prefill_done >= 0:
            self._first_token(st, max(self.now, st.prefill_done))

    # ---- engine ------------------------------------------------------------

    def _engine_maybe_start(self) -> None:
        if self.engine_busy:
            return
        self._sweep_stale_partials()
        import time as _t
        t0 = _t.perf_counter()
        act = self.sched.next_action(len(self.decode_running),
                                     refresh=self._job_lens)
        self.sched_times.append(_t.perf_counter() - t0)
        if act.kind == PREFILL:
            self._start_prefill_batch(act.chunks)
        elif act.kind == DECODE:
            self._start_decode()

    def _sweep_stale_partials(self) -> None:
        """Chunk-boundary cancellation (Alg. 2 at chunk grain): abort any
        in-flight chunked prefill whose job went stale between iterations —
        unpin its hit prefix and never compute the remaining chunks."""
        for job in [j for j in self._partial_jobs
                    if j.cancelled or j.req.done]:
            self._abort_chunked(job)

    def _abort_chunked(self, job: _Job) -> None:
        for n in job.plan.hit_nodes:      # unpin without inserting partials
            n.pinned = False
        self.chunks_cancelled += 1
        self.chunk_tokens_saved += sum(job.pending)
        job.pending = []
        self._partial_jobs.remove(job)
        self.sched.abort_prefill(job)

    def _cached_tokens(self, docs, doc_tokens) -> int:
        """Reusable-token estimate for reordering/admission: prefix mode
        counts the longest cached prefix, chunk mode counts each cached doc
        minus its page-aligned boundary recompute (same arithmetic as the
        real runtime's ``_job_ctx_beta``)."""
        if self.cfg.reuse != "chunk":
            return sum(n.n_tokens for n in self.tree.match_prefix(docs))
        cached = 0
        for i, node in enumerate(self.tree.match_chunks(docs)):
            if node is None:
                continue
            n_tok = int(doc_tokens[i])
            if node.exact_ctx and node.src_prefix == tuple(docs[:i]):
                cached += n_tok
            else:
                cached += n_tok - effective_recompute(
                    self.cfg.recompute_tokens, n_tok, self.cfg.block_size)
        return cached

    def _job_lens(self, job: _Job) -> Tuple[int, int]:
        doc_tokens = [int(self.corpus.doc_lengths[i]) for i in job.docs]
        cached = self._cached_tokens(job.docs, doc_tokens)
        total = sum(doc_tokens) + len(job.req.r.question_tokens)
        return cached, max(total - cached, 1)

    def _start_prefill_batch(self, chunks) -> None:
        """One engine iteration: the next chunk of every job the scheduler
        packed.  Iteration time = promotion transfers (first chunks) + the
        analytic compute cost apportioned per chunk token, summed over the
        ragged batch."""
        dt = 0.0
        ran = []
        for ch in chunks:
            job = ch.item
            st = job.req
            if job.cancelled or st.done:
                if job.plan is not None:
                    self._abort_chunked(job)
                else:
                    self.sched.abort_prefill(job)
                continue
            if job.plan is None:
                dt += self._begin_chunked(job)
            n = job.pending.pop(0)
            dt += n * job.sec_per_token
            ran.append(job)
        self.engine_busy = True
        if ran:                         # all-stale batches executed nothing
            self.prefill_batches.append(len(ran))
            dt *= self._jitter()
        self._push(self.now + dt, "prefill_batch_done", ran)

    def _begin_chunked(self, job: _Job) -> float:
        """Plan + promote on the first chunk; piece sizes come from the
        shared splitter (same chunk boundaries as the real runtime).
        Returns the promotion transfer seconds."""
        st = job.req
        doc_tokens = [int(self.corpus.doc_lengths[i]) for i in job.docs]
        q_tokens = len(st.r.question_tokens) + self.cfg.system_prompt_tokens
        if self.cfg.reuse == "chunk":
            plan = self.controller.plan_chunks(
                job.docs, doc_tokens, q_tokens,
                recompute_tokens=self.cfg.recompute_tokens,
                block_size=self.cfg.block_size)
        else:
            plan = self.controller.plan(job.docs, doc_tokens, q_tokens)
        transfer = self.controller.promote(plan)
        compute = self.tree.profiler.estimate(plan.alpha, plan.beta)
        job.plan = plan
        job.started = self.now
        if plan.chunks is not None:
            # compute segments: whole missed docs + reloc boundary heads
            seg_lens = [it.n_tokens if it.kind == "miss" else it.recompute
                        for it in plan.chunks if it.kind != "exact"]
            seg_lens.append(plan.question_tokens)
        else:
            seg_lens = list(plan.doc_tokens[len(plan.hit_nodes):]) \
                + [plan.question_tokens]
        job.pending = prefill_piece_sizes(seg_lens, self.cfg.prefill_chunk) \
            or [1]
        job.sec_per_token = compute / max(sum(job.pending), 1)
        self._partial_jobs.append(job)
        if st.final_docs is not None and job.docs == st.final_docs \
                and st.final_prefill_first_start < 0:
            st.final_prefill_first_start = self.now
        elif st.final_docs is None:
            # provisional docs may turn out final; record candidate start
            job.start_candidate = self.now
            st.spec_start_by_docs.setdefault(job.docs, self.now)
        return transfer

    def _on_prefill_batch_done(self, ran: List[_Job]) -> None:
        self.engine_busy = False
        # pass 1: settle every chunk with the scheduler BEFORE any side
        # effect — _first_token below can re-enter _engine_maybe_start, and
        # the packed batch's other jobs must already be consistent
        completed = []
        for job in ran:
            st = job.req
            if job.pending:
                if job.cancelled or st.done:
                    self._abort_chunked(job)
                else:
                    self.sched.note_chunk_done(job, job.pending)
                continue
            # prefill complete (a stale job still finishes its last chunk:
            # the paper cancels "after the current iteration")
            self.sched.note_chunk_done(job, [])
            self._partial_jobs.remove(job)
            completed.append(job)
        # pass 2: commits + first tokens
        for job in completed:
            st = job.req
            if not (job.cancelled or st.done):
                # completed prefills populate the tree even if speculative;
                # §8 "Large top-k": optionally cache only the leading docs
                if job.plan.chunks is not None:
                    self.controller.commit_chunks(
                        job.plan, max_docs=self.cfg.cache_top_k or None)
                else:
                    self.controller.commit(
                        job.plan, max_docs=self.cfg.cache_top_k or None)
                st.prefill_done = self.now
                st.prefill_docs = job.docs
                if st.final_docs is not None and job.docs == st.final_docs:
                    st.hit_tier_tokens = job.plan.hit_tier_tokens
                    if st.final_prefill_first_start < 0:
                        st.final_prefill_first_start = job.started
                    self._first_token(st, max(self.now, st.search_end))
                # else: wasted speculation; final job is queued already
            else:
                for n in job.plan.hit_nodes:   # unpin without inserting
                    n.pinned = False
        self._engine_maybe_start()

    def _first_token(self, st: _ReqState, t: float) -> None:
        if st.ttft >= 0:
            return
        # credit speculative start for the non-overlap metric
        if st.final_prefill_first_start < 0:
            cand = st.spec_start_by_docs.get(st.final_docs)
            if cand is not None:
                st.final_prefill_first_start = cand
        st.ttft = t - st.r.arrival
        st.context = (sum(int(self.corpus.doc_lengths[i]) for i in st.final_docs)
                      + len(st.r.question_tokens))
        st.remaining_out -= 1
        if st.remaining_out <= 0:
            st.done = True
            st.finish_time = t
        else:
            self.decode_running.append(st)
        self._engine_maybe_start()

    def _start_decode(self) -> None:
        batch = list(self.decode_running)
        ctx = float(np.mean([s.context for s in batch]))
        dt = self.cfg.profile.decode_time(len(batch), ctx) * self._jitter()
        self.engine_busy = True
        self._push(self.now + dt, "decode_done", batch)

    def _on_decode_done(self, batch: List[_ReqState]) -> None:
        self.engine_busy = False
        for st in batch:
            if st not in self.decode_running:
                continue
            st.context += 1
            st.remaining_out -= 1
            st.token_times.append(self.now)
            if st.remaining_out <= 0:
                st.done = True
                st.finish_time = self.now
                self.decode_running.remove(st)
        self._engine_maybe_start()

    # ---- metrics -------------------------------------------------------------

    def _metrics(self) -> SimMetrics:
        ttfts = []
        non_overlaps = []
        finishes = []
        wasted = 0
        for st in self._all_states:
            if st.ttft >= 0:
                ttfts.append(st.ttft)
                dur = st.search_end - st.search_start
                if st.final_prefill_first_start >= 0:
                    overlap = max(0.0, st.search_end
                                  - max(st.search_start,
                                        st.final_prefill_first_start))
                else:
                    overlap = 0.0
                non_overlaps.append(max(0.0, dur - min(overlap, dur)))
                finishes.append(getattr(st, "finish_time", st.search_end))
            wasted += st.spec.wasted_launches
        tpots = []
        for st in self._all_states:
            if len(st.token_times) >= 1 and st.ttft >= 0:
                t0 = st.r.arrival + st.ttft
                tpots.append((st.token_times[-1] - t0)
                             / max(len(st.token_times), 1))
        ttfts_a = np.asarray(ttfts) if ttfts else np.asarray([0.0])
        duration = (max(finishes) - min(r.arrival for r in self.requests)
                    if finishes else 0.0)
        return SimMetrics(
            avg_ttft=float(ttfts_a.mean()),
            p50_ttft=float(np.percentile(ttfts_a, 50)),
            p99_ttft=float(np.percentile(ttfts_a, 99)),
            avg_tpot=float(np.mean(tpots)) if tpots else 0.0,
            doc_hit_rate=self.controller.doc_hit_rate,
            completed=len(ttfts),
            duration=float(duration),
            throughput_rps=len(ttfts) / duration if duration > 0 else 0.0,
            avg_non_overlap_search=float(np.mean(non_overlaps)) if non_overlaps else 0.0,
            wasted_prefills=wasted,
            gpu_evictions=self.tree.stats["gpu_evictions"],
            swap_out_bytes=self.tree.stats["swap_out_bytes"],
            disk_evictions=self.tree.stats["disk_evictions"],
            spill_bytes=self.tree.stats["spill_bytes"],
            fetch_bytes=self.tree.stats["fetch_bytes"],
            hit_tokens_gpu=self.tree.stats["hit_tokens_gpu"],
            hit_tokens_host=self.tree.stats["hit_tokens_host"],
            hit_tokens_disk=self.tree.stats["hit_tokens_disk"],
            chunks_cancelled=self.chunks_cancelled,
            chunk_tokens_saved=self.chunk_tokens_saved,
            prefill_iterations=len(self.prefill_batches),
            avg_prefill_batch=(float(np.mean(self.prefill_batches))
                               if self.prefill_batches else 0.0),
            retrieval_stages=self.retrieval_stages,
            ttfts=list(map(float, ttfts)),
            disk_hit_ttfts=[float(st.ttft) for st in self._all_states
                            if st.ttft >= 0 and st.hit_tier_tokens[2] > 0],
        )


# --------------------------------------------------------------------------
# multi-replica simulation: the same ReplicaRouter that launch/serve.py uses
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FleetSimResult:
    """Outcome of a multi-replica simulation: the cross-replica merge, the
    per-replica metrics, and the router's routing/skew accounting."""
    metrics: SimMetrics
    per_replica: List[SimMetrics]
    router_stats: Dict[str, object]


def _wmean(pairs: List[Tuple[float, float]]) -> float:
    """Weighted mean over (value, weight), 0.0 when all weights are zero."""
    tot = sum(w for _, w in pairs)
    return sum(v * w for v, w in pairs) / tot if tot > 0 else 0.0


def merge_sim_metrics(parts: Sequence[SimMetrics]) -> SimMetrics:
    """Cross-replica SimMetrics: percentiles recomputed over the pooled
    per-request TTFTs (exact), ratio metrics completion-weighted, counters
    summed, duration = the slowest replica (replicas run concurrently)."""
    ttfts = [t for m in parts for t in m.ttfts]
    ttfts_a = np.asarray(ttfts) if ttfts else np.asarray([0.0])
    completed = sum(m.completed for m in parts)
    duration = max((m.duration for m in parts), default=0.0)
    return SimMetrics(
        avg_ttft=float(ttfts_a.mean()),
        p50_ttft=float(np.percentile(ttfts_a, 50)),
        p99_ttft=float(np.percentile(ttfts_a, 99)),
        avg_tpot=_wmean([(m.avg_tpot, m.completed) for m in parts]),
        doc_hit_rate=_wmean([(m.doc_hit_rate, m.completed) for m in parts]),
        completed=completed,
        duration=float(duration),
        throughput_rps=completed / duration if duration > 0 else 0.0,
        avg_non_overlap_search=_wmean(
            [(m.avg_non_overlap_search, m.completed) for m in parts]),
        wasted_prefills=sum(m.wasted_prefills for m in parts),
        gpu_evictions=sum(m.gpu_evictions for m in parts),
        swap_out_bytes=sum(m.swap_out_bytes for m in parts),
        disk_evictions=sum(m.disk_evictions for m in parts),
        spill_bytes=sum(m.spill_bytes for m in parts),
        fetch_bytes=sum(m.fetch_bytes for m in parts),
        hit_tokens_gpu=sum(m.hit_tokens_gpu for m in parts),
        hit_tokens_host=sum(m.hit_tokens_host for m in parts),
        hit_tokens_disk=sum(m.hit_tokens_disk for m in parts),
        chunks_cancelled=sum(m.chunks_cancelled for m in parts),
        chunk_tokens_saved=sum(m.chunk_tokens_saved for m in parts),
        prefill_iterations=sum(m.prefill_iterations for m in parts),
        avg_prefill_batch=_wmean(
            [(m.avg_prefill_batch, m.prefill_iterations) for m in parts]),
        retrieval_stages=sum(m.retrieval_stages for m in parts),
        ttfts=list(map(float, ttfts)),
        disk_hit_ttfts=[t for m in parts for t in m.disk_hit_ttfts],
    )


def simulate_replicas(cfg: SimConfig, corpus: Corpus, index,
                      requests: Sequence[Request], *,
                      n_replicas: int = 1, routing: str = AFFINITY,
                      max_queue_skew: int = 4,
                      profiler: Optional[CostProfiler] = None
                      ) -> FleetSimResult:
    """Simulate N independent engine replicas behind a ``ReplicaRouter``.

    Each replica is a full ``RAGSimulator`` — its own ``KnowledgeTree``,
    scheduler and three-tier cache; no state is shared across replicas.
    The router object is the SAME class ``launch/serve.py`` drives over
    real ``ContinuousRuntime`` replicas (mirroring how the scheduler is
    shared), so simulated and real routing policy cannot drift: the trace
    is partitioned through ``partition_requests`` in arrival order, keyed
    by each request's (deterministic) retrieved doc IDs.
    """
    sims = [RAGSimulator(cfg, corpus, index, [], profiler=profiler)
            for _ in range(n_replicas)]
    router = ReplicaRouter(sims, config=FleetConfig(
        replicas=len(sims), routing=routing, max_queue_skew=max_queue_skew))
    ordered = sorted(requests, key=lambda r: r.arrival)
    # in-flight window: each replica drains max_batch requests concurrently
    # while the trace keeps arriving, so backlog — what the escape hatch
    # bounds — is a sliding window over the most recent dispatches
    shares = partition_requests(
        router, ordered,
        docs_of=lambda r: index.search(r.query_vec, cfg.top_k),
        doc_tokens_of=lambda docs: [int(corpus.doc_lengths[d])
                                    for d in docs],
        context_of=lambda r, docs, toks: (sum(toks)
                                          + len(r.question_tokens)
                                          + cfg.system_prompt_tokens),
        window=2 * cfg.max_batch * n_replicas)
    per = []
    for sim, share in zip(sims, shares):
        sim.requests = list(share)
        per.append(sim.run())
    return FleetSimResult(metrics=merge_sim_metrics(per), per_replica=per,
                          router_stats=router.stats())


@dataclasses.dataclass
class FrontDoorSimResult:
    metrics: SimMetrics            # pooled, INCLUDING front-door hits (each
    #                                charged FrontDoor.LOOKUP_SECONDS TTFT)
    miss_metrics: SimMetrics       # engine-served misses only
    per_replica: List[SimMetrics]
    router_stats: Dict[str, object]
    frontdoor_stats: Dict[str, object]
    partition: object              # frontdoor.FrontDoorPartition


def simulate_frontdoor(cfg: SimConfig, corpus: Corpus, index,
                       requests: Sequence[Request], frontdoor, *,
                       n_replicas: int = 1, routing: str = AFFINITY,
                       max_queue_skew: int = 4,
                       profiler: Optional[CostProfiler] = None
                       ) -> FrontDoorSimResult:
    """Simulate the full front-door stack: query cache -> SLO admission ->
    autoscaler -> ``ReplicaRouter`` -> N ``RAGSimulator`` replicas.

    ``frontdoor`` is a ``serving.frontdoor.FrontDoor`` — the SAME policy
    object ``launch/serve.py --frontdoor`` drives over real runtimes,
    walked through the SAME ``frontdoor_partition`` trace walk, so
    front-door policy cannot drift between simulation and reality
    (one policy object shared by the simulator and the real runtime).

    Cache hits never reach a replica; they are charged the front door's
    analytic lookup cost as TTFT and pooled into ``metrics`` so
    "front door on vs off" comparisons are honest about what the cache
    absorbed.  Shed requests are dropped (counted in frontdoor_stats).
    """
    from repro_torch.serving.frontdoor import frontdoor_partition

    sims = [RAGSimulator(cfg, corpus, index, [], profiler=profiler)
            for _ in range(n_replicas)]
    router = ReplicaRouter(sims, config=FleetConfig(
        replicas=len(sims), routing=routing, max_queue_skew=max_queue_skew))

    def _k(r):
        return min(r.top_k, cfg.top_k) if r.top_k > 0 else cfg.top_k

    part = frontdoor_partition(
        frontdoor, router, requests,
        docs_of=lambda r: index.search(r.query_vec, _k(r)),
        doc_tokens_of=lambda docs: [int(corpus.doc_lengths[d])
                                    for d in docs],
        context_of=lambda r, docs, toks: (sum(toks)
                                          + len(r.question_tokens)
                                          + cfg.system_prompt_tokens),
        window=2 * cfg.max_batch * n_replicas)
    per = []
    for sim, share in zip(sims, part.shares):
        sim.requests = list(share)
        per.append(sim.run())
    miss = merge_sim_metrics(per)
    # pool the hits back in at the analytic lookup cost
    hit_ttfts = [frontdoor.LOOKUP_SECONDS] * len(part.hits)
    ttfts = list(miss.ttfts) + hit_ttfts
    ttfts_a = np.asarray(ttfts) if ttfts else np.asarray([0.0])
    completed = miss.completed + len(part.hits)
    pooled = dataclasses.replace(
        miss,
        avg_ttft=float(ttfts_a.mean()),
        p50_ttft=float(np.percentile(ttfts_a, 50)),
        p99_ttft=float(np.percentile(ttfts_a, 99)),
        completed=completed,
        throughput_rps=(completed / miss.duration
                        if miss.duration > 0 else 0.0),
        ttfts=list(map(float, ttfts)))
    return FrontDoorSimResult(metrics=pooled, miss_metrics=miss,
                              per_replica=per, router_stats=router.stats(),
                              frontdoor_stats=frontdoor.stats(),
                              partition=part)
