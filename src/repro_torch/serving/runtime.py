"""Continuous-batching async serving runtime (counterpart of
``repro.serving.runtime``).

The event-loop engine of the paper's serving numbers: iteration-level
scheduling over many concurrent requests, with

  * staged vector search running OFF the engine's critical path — each
    request's search stages are events on the runtime clock, and the
    ``SpeculativeController``'s per-stage decisions launch and terminate
    speculative prefills that overlap the remaining search (paper §5.3);
  * one engine iteration at a time: a chunked, ragged-batched paged
    prefill iteration — continuations of in-flight chunked prefills plus
    newly admitted jobs picked by the cache-aware ``ReorderQueue`` — or ONE
    batched paged decode step for every running request.  Both steps run
    straight against the ``PagedKVStore`` pool through run tables and the
    hand-written CUDA kernels (plain PyTorch on the CPU), writing new K/V
    into the pool in place.  ``attn="dense"`` keeps the A/B baseline
    instead: each piece prefills through the dense prefill over the
    gathered cached prefix, and decode gathers a dense cache from the pool
    by slot map every step;
  * admission control and preemption by paged-block / tree-pin budget via
    the shared ``ContinuousBatchScheduler``;
  * the knowledge tree's GPU -> host -> disk cascade, with disk reads for a
    matched prefix prefetched into host memory during the remaining
    retrieval stages.

Clock semantics: the runtime keeps a virtual clock (seconds).  Engine
iterations advance it by their measured wall time, and every iteration
ends in a device synchronise, so the time covers the device work and not
just the launches.  Retrieval stages advance their own per-request lanes by
max(measured stage wall time, analytic stage cost).  TTFT is therefore
max(search_end, prefill_end) - arrival.

Spans (``RuntimeMetrics``, always on): each handler's body
(``runtime.<kind>``), each engine step (``engine.decode`` /
``engine.prefill``) split into issuing it (``.plan``, ``.pack``,
``.launch``) and waiting for the device (``.wait``), each tier copy
(``tree.demote`` / ``.promote`` / ``.spill`` / ``.fetch``) and each staged
search (``retrieval.search``), on ``time.perf_counter_ns``: the virtual
clock's own measurements are untouched.  ``LATEST`` keeps the metrics of
the runtime that last entered ``serve()``.

``mode="cag"`` preloads the whole corpus KV into the disk tier at start-up,
each doc computed standalone through the dense prefill, and serves with
zero retrieval stages.

``reuse="chunk"`` caches each doc on its own and reuses it at any
position: an exact hit shares its pages whole, a relocated hit recomputes
its page-aligned head at the new position and shares its tail in place
(approximate; results carry ``exact=False``).

Families: the attention families (dense, MoE, and the VLM's text
backbone).  Recurrent state cannot be paged per-block.

Tensor parallelism (``config.mesh.tp > 1``, the reference's single-
controller model): the params shard per ``launch/sharding.py::
serving_param_shardings`` over a ``(1, tp)`` mesh of devices (the cards
``cuda:0 .. tp-1``, tp CPU shards with ``device="cpu"``, or an explicit
``mesh``), the pool's planes shard whole KV heads, and
``ShardedPagedBackend`` moves each shard's head slice between the tiers.
Block tables, slot mappings and run tables stay single, so every scheduler
and tree decision is the same at any tp, and the tokens, tier hits and
first-token logits are those of a one-device mesh of the same column-slab
group (``launch/mesh.py``) bit for bit.  The runtime holds only the
shards: CAG preloads through the dense prefill over the mesh.  The MoE
family shards its router and expert stacks by the reference's rules
(``launch/sharding.py::placer``: whole experts a shard when the group
divides E, else d_ff slabs; the expert ``wd`` on the controller), with the
dense family's pool, backend and copies.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import heapq
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as autograd_profiler

from repro_torch.core.controller import RAGController, effective_recompute
from repro_torch.core.knowledge_tree import (CacheBackend, EvictionError,
                                             KnowledgeTree)
from repro_torch.core.profiler import CostProfiler
from repro_torch.core.speculative import SpecState, SpeculativeController
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.sharding import assert_tp_compatible, shard_params
from repro_torch.kvcache.paged import (DiskSegmentStore, OutOfBlocks,
                                       PagedKVStore, PagedSegment,
                                       make_disk_store, to_host)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.retrieval.corpus import Corpus, Request
from repro_torch.serving.config import EngineConfig, reject_legacy_kwargs
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import (DECODE, PREEMPT, PREFILL,
                                           ContinuousBatchScheduler,
                                           PagedAdmission, SchedulerConfig,
                                           prefill_piece_sizes)

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"

SPAN_CAPACITY = 65536          # newest spans a RuntimeMetrics keeps

# the RuntimeMetrics of the runtime that last entered serve(); it outlives
# the runtime, for an exporter that reads the spans afterwards
LATEST: Optional["RuntimeMetrics"] = None


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` in page-locked memory when it feeds a copy to a CUDA device."""
    return t.pin_memory() if device.type == "cuda" else t


def host_bytes(node) -> int:
    """Bytes of a node's host copy (K and V), the size of every tier hop."""
    return node.payload_host["k"].nbytes + node.payload_host["v"].nbytes


class Span:
    """One span, its own record once closed: a name, a start and a
    duration on ``time.perf_counter_ns`` (this module's clock, not the
    runtime's virtual one), a few int / float ``attrs`` (rows, bytes, ...),
    and whether a torch profiler was recording.  Two clock reads and one
    append; while a profiler records, a ``record_function`` range named
    ``host:<name>`` besides, which puts the span on the kernels' timeline.
    A closed span holds numbers only."""
    __slots__ = ("name", "start_ns", "dur_ns", "attrs", "profiled",
                 "_metrics", "_range")

    def __init__(self, metrics: "RuntimeMetrics", name: str):
        self._metrics, self.name, self.attrs = metrics, name, {}

    def __enter__(self) -> "Span":
        # a rebound module global, so read through the module every time
        self._range = None
        if autograd_profiler._is_profiler_enabled:
            self._range = autograd_profiler.record_function(
                "host:" + self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.dur_ns = time.perf_counter_ns() - self.start_ns
        rng, m = self._range, self._metrics
        self.profiled = rng is not None
        if rng is not None:
            rng.__exit__(*exc)
        self._range = self._metrics = None
        if len(m.spans) == m.spans.maxlen:
            m.spans_dropped += 1
        m.spans.append(self)


class RuntimeMetrics(ServingMetrics):
    """The continuous runtime's ``ServingMetrics``: the shared timelines and
    counters (``serving/metrics.py``, a copy of the reference's) plus the
    port's spans, a bounded record of where the host spent each handler,
    engine step (issuing it, then waiting for the device), retrieval search
    and tier copy, and two counters the spans need beside them."""

    def __init__(self):
        super().__init__()
        # tokens computed for prefills dropped as stale: finished ones
        # (wasted_prefills) and those cancelled at a chunk boundary
        self.wasted_prefill_tokens = 0
        self.pool_blocks_peak = 0      # most pool blocks in use after a step
        # spans, oldest first; spans_dropped counts those pushed out
        self.spans: collections.deque = collections.deque(
            maxlen=SPAN_CAPACITY)
        self.spans_dropped = 0
        self.serve_ns: Optional[int] = None   # the latest serve()'s start

    def span(self, name: str) -> Span:
        """``with metrics.span(name) as sp: ...``; set ``sp.attrs`` inside."""
        return Span(self, name)

    def stamp_serve(self) -> None:
        """A ``serve()`` begins: stamp it, and make these the LATEST."""
        global LATEST
        LATEST = self
        self.serve_ns = time.perf_counter_ns()

    def summary(self) -> Dict[str, object]:
        s = super().summary()
        s["wasted_prefill_tokens"] = self.wasted_prefill_tokens
        s["pool_blocks_peak"] = self.pool_blocks_peak
        return s

    def format_report(self) -> str:
        """The shared report, then the two counters and a line a span name:
        its count, mean and p95 over the spans kept."""
        lines = [super().format_report(),
                 f"wasted prefill tokens   : {self.wasted_prefill_tokens}",
                 f"pool blocks peak in use : {self.pool_blocks_peak}"]
        by_name: Dict[str, List[int]] = {}
        for sp in self.spans:
            by_name.setdefault(sp.name, []).append(sp.dur_ns)
        for name, durs in sorted(by_name.items()):
            a = np.asarray(durs, np.float64) / 1e6
            lines.append(f"span {name:<27}: n {len(a):>6}  mean "
                         f"{a.mean():9.3f}  p95 "
                         f"{np.percentile(a, 95):9.3f} ms")
        if self.spans_dropped:
            lines.append(f"spans dropped           : {self.spans_dropped} "
                         f"(the oldest; {len(self.spans)} kept)")
        return "\n".join(lines)


def _handler_span(handler):
    """Runs an ``_on_<kind>`` handler's body under the span
    ``runtime.<kind>``: whatever wraps the method from outside (a pacing
    wait) stays outside the span."""
    name = "runtime." + handler.__name__[len("_on_"):]

    @functools.wraps(handler)
    def run(self, payload):
        with self.metrics.span(name):
            return handler(self, payload)
    return run


class PagedBackend(CacheBackend):
    """Tree payloads are PagedSegments in the shared device store; the host
    tier holds dense (pinned, on a CUDA store) CPU tensor copies; the
    optional disk tier holds one file per node.  Transfer seconds are
    measured, and each copy is a span of ``metrics`` (``tree.demote``,
    ``tree.promote``, ``tree.spill``, ``tree.fetch``), with the bytes of
    the host copy it moves."""

    def __init__(self, store: PagedKVStore,
                 disk: Optional[DiskSegmentStore] = None,
                 metrics: Optional[RuntimeMetrics] = None):
        self.store = store
        self.disk = disk
        self.metrics = metrics if metrics is not None else RuntimeMetrics()

    def swap_out(self, node):
        with self.metrics.span("tree.demote") as sp:
            t0 = time.perf_counter()
            k, v = self.store.gather(node.payload_gpu)
            node.payload_host = {"k": to_host(k), "v": to_host(v)}
            sp.attrs = {"bytes": host_bytes(node)}
            return time.perf_counter() - t0

    def load(self, node):
        with self.metrics.span("tree.promote") as sp:
            sp.attrs = {"bytes": host_bytes(node)}
            t0 = time.perf_counter()
            try:
                node.payload_gpu = self.store.put(node.payload_host["k"],
                                                  node.payload_host["v"])
            except OutOfBlocks as e:
                raise EvictionError(str(e))   # promote() degrades to
                                              # recompute
            self.store.sync()
            return time.perf_counter() - t0

    def spill(self, node):
        with self.metrics.span("tree.spill") as sp:
            sp.attrs = {"bytes": host_bytes(node)}
            t0 = time.perf_counter()
            node.payload_disk = self.disk.write(node.payload_host["k"],
                                                node.payload_host["v"])
            return time.perf_counter() - t0

    def fetch(self, node):
        with self.metrics.span("tree.fetch") as sp:
            t0 = time.perf_counter()
            k, v = self.disk.read(node.payload_disk)
            node.payload_host = {"k": pinned(k, self.store.device),
                                 "v": pinned(v, self.store.device)}
            sp.attrs = {"bytes": host_bytes(node)}
            return time.perf_counter() - t0

    def free_gpu(self, node):
        if node.payload_gpu is not None:
            self.store.free(node.payload_gpu)
        node.payload_gpu = None

    def free_disk(self, node):
        if node.payload_disk is not None:
            self.disk.delete(node.payload_disk)
        node.payload_disk = None


class ShardedPagedBackend(PagedBackend):
    """The tensor-parallel pool's backend (counterpart of
    ``repro.serving.runtime.ShardedPagedBackend``): ``PagedBackend``'s tier
    semantics over a KV-head-sharded pool, each hop copying per shard.

      * demote (``swap_out``): each shard's head slice is pulled once into
        its heads of one (pinned) host copy of the whole heads;
      * promote (``load``, inherited): ``store.put`` splits the host copy
        through ``_shard_segment``, one copy per shard; ``OutOfBlocks``
        becomes ``EvictionError``.
    """

    def swap_out(self, node):
        with self.metrics.span("tree.demote") as sp:
            t0 = time.perf_counter()
            seg = node.payload_gpu
            host = {}
            for name, pieces in zip(("k", "v"),
                                    self.store.gather_shards(seg)):
                L, _, T, n, hd = pieces[0].shape
                h = torch.empty((L, 1, T, n * len(pieces), hd),
                                dtype=pieces[0].dtype,
                                pin_memory=pieces[0].is_cuda)
                for i, piece in enumerate(pieces):
                    h[..., i * n:(i + 1) * n, :].copy_(piece)
                host[name] = h
            node.payload_host = host
            sp.attrs = {"bytes": host_bytes(node)}
            return time.perf_counter() - t0


@dataclasses.dataclass
class _PrefillResult:
    docs: Tuple[int, ...]
    cache: Optional[dict]           # dense full-sequence cache (L, 1, T, ...)
                                    # — None in paged mode
    first_token: int
    total_len: int
    alpha: int
    beta: int
    hit_docs: int
    hit_tier_tokens: Tuple[int, int, int]   # alpha split by (gpu, host, disk)
    speculative: bool
    started: float
    # paged mode: the computed KV already lives in the pool: hit_runs are
    # (blocks, n_tokens) snapshots of the shared (incref'd) prefix nodes;
    # pg_segs are the request-owned segments (uncached docs + question), in
    # sequence order.  Both lists are emptied when _paginate consumes them
    # (ownership transfers to the decode table) or _free_paged_kv drops them.
    hit_runs: List[Tuple[List[int], int]] = dataclasses.field(
        default_factory=list)
    pg_segs: List[PagedSegment] = dataclasses.field(default_factory=list)
    # ordered sequence layout: ("run"|"seg", index into hit_runs/pg_segs,
    # absolute start position).  Prefix mode is runs-then-segs; chunk mode
    # (--reuse chunk) interleaves shared runs and computed segments.
    layout: List[Tuple[str, int, int]] = dataclasses.field(
        default_factory=list)
    exact: bool = True              # False once a relocated chunk was reused
    first_logits: Optional[np.ndarray] = None   # (V,) at the first token


@dataclasses.dataclass
class _ChunkState:
    """Engine-side state of an in-flight chunked prefill: plan, execution
    cursor over the to-be-computed segments, remaining piece sizes, and the
    pages the kernel scatters each chunk's KV into (paged mode) or the
    partial KV paged into the store between iterations (dense mode)."""
    plan: object                    # RequestPlan
    segs: List[np.ndarray]          # token arrays: uncached docs + question
    doc_bounds: List[Tuple[int, int]]  # (abs_start, length) per uncached doc
    pieces: List[int]               # remaining piece sizes (shared splitter)
    seg_idx: int = 0
    seg_off: int = 0
    plen: int = 0                   # absolute tokens prefixed so far
    first_token: int = -1           # set when the last piece completes
    logits: Optional[np.ndarray] = None
    # dense mode: the cached prefix gathered out of the pool, the partial
    # KV of earlier pieces, and the full-sequence cache once the last piece
    # completes (commit / paginate read it)
    prefix_hit: Optional[dict] = None
    partial_seg: Optional[PagedSegment] = None
    cache: Optional[dict] = None
    hit_runs: List[Tuple[List[int], int]] = dataclasses.field(
        default_factory=list)
    pg_segs: List[PagedSegment] = dataclasses.field(default_factory=list)
    # paged mode: ordered layout of the full sequence (see _PrefillResult).
    # seg_abs[i] is the absolute start of compute segment i — chunk mode
    # scatters compute segments between shared runs, so the cursor's
    # q_start is seg_abs[seg_idx] + seg_off, not a running prefix.
    layout: List[Tuple[str, int, int]] = dataclasses.field(
        default_factory=list)
    seg_abs: List[int] = dataclasses.field(default_factory=list)
    miss_segs: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Job:
    req: "_ReqRun"
    docs: Tuple[int, ...]
    speculative: bool
    enqueued: float
    cancelled: bool = False
    started: float = -1.0
    cs: Optional[_ChunkState] = None


@dataclasses.dataclass
class _ReqRun:
    r: Request
    tl: object                      # RequestTimeline
    spec: SpecState
    state: str = WAITING
    final_docs: Optional[Tuple[int, ...]] = None
    jobs: List[_Job] = dataclasses.field(default_factory=list)
    results: Dict[Tuple[int, ...], _PrefillResult] = dataclasses.field(
        default_factory=dict)
    start_by_docs: Dict[Tuple[int, ...], float] = dataclasses.field(
        default_factory=dict)
    # decode state: token-level slot mapping — position p of the request's
    # sequence lives at (pos_blk[p], pos_slot[p]) in the paged store
    pos_blk: List[int] = dataclasses.field(default_factory=list)
    pos_slot: List[int] = dataclasses.field(default_factory=list)
    owned_blocks: List[int] = dataclasses.field(default_factory=list)
    length: int = 0
    last_tok: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    exact: bool = True
    first_logits: Optional[np.ndarray] = None


@dataclasses.dataclass
class RuntimeResult:
    req_id: int
    tokens: List[int]
    ttft: float
    docs: Tuple[int, ...]
    alpha: int
    beta: int
    speculative_hit: bool
    # chunk-cache mode: False when a relocated chunk was reused (outputs are
    # approximate — verify with --check-tokens tol:<eps>); prefix mode and
    # full recomputes stay True (the bit-identical contract holds).
    exact: bool = True
    first_logits: Optional[np.ndarray] = None   # (V,) logits at first token


class ContinuousRuntime:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        corpus: Corpus,
        index,
        *,
        config: Optional[EngineConfig] = None,
        n_blocks: Optional[int] = None,
        reorder_window: int = 32,
        profiler: Optional[CostProfiler] = None,
        device=None,
        mesh=None,
        **legacy,
    ):
        # ``config=`` is the sole constructor API (serving/config.py).
        # ``device``: None resolves to CUDA and raises without it; the CPU
        # runs only when asked for (the tests).  ``mesh``: the serving mesh
        # of ``config.mesh.tp`` shards (launch/mesh.py); None builds the
        # default one on ``device``.
        reject_legacy_kwargs("ContinuousRuntime", legacy, EngineConfig)
        config = config if config is not None else EngineConfig()
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                "recurrent-state families cannot be paged per-block")
        if config.attn not in ("dense", "paged", "auto"):
            raise ValueError(f"unknown attn mode {config.attn!r}")
        # "auto" resolves to the paged engine; the dense gather survives as
        # the explicit --attn dense A/B baseline
        self.attn = "paged" if config.attn == "auto" else config.attn
        if config.reuse not in ("prefix", "chunk"):
            raise ValueError(f"unknown reuse mode {config.reuse!r}")
        if config.reuse == "chunk" and self.attn != "paged":
            # relocated reuse needs per-run absolute positions in the run
            # table — the dense gather has no such contract
            raise ValueError("--reuse chunk requires the paged engine "
                             "(--attn paged/auto)")
        self.reuse = config.reuse
        self.recompute_tokens = int(config.recompute_tokens)
        self.mode = config.mode
        if self.mode == "cag" and config.disk_cache_bytes <= 0:
            raise ValueError(
                "mode='cag' preloads the whole corpus KV into the disk tier "
                "and needs disk_cache_bytes > 0 sized for the corpus")
        self.device = resolve_device(device)
        self.attn_impl = config.attn_impl
        self.cfg = cfg
        self.corpus = corpus
        self.index = index
        self.top_k = config.top_k
        self.search_time_scale = config.search_time_scale
        # ---- the serving mesh: one replica over tp devices (one at tp 1) --
        tp = config.mesh.tp
        if tp > 1:
            assert_tp_compatible(cfg, tp)
        if mesh is None:
            mesh = make_serving_mesh(tp, device=self.device)
        if mesh.shape["model"] != tp:
            raise ValueError(f"mesh of {mesh.shape['model']} shards for tp "
                             f"{tp}")
        self._mesh = mesh
        self.device = mesh.controller
        # params: a tree, sharded here (copies, so nothing here keeps a
        # whole tree alive), or shard_params' list for this mesh
        if not isinstance(params, list):
            params = shard_params(params, cfg, mesh)
        if len(params) != tp:
            raise ValueError(f"{len(params)} param shards for tp {tp}")
        self.params = params
        kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd
                    * cfg.tdtype.itemsize)
        if n_blocks is None:
            n_blocks = int(np.clip(
                config.gpu_cache_bytes // (config.block_size * kv_bytes) + 64,
                128, 4096))
        self.store = PagedKVStore(cfg.n_layers, n_blocks, config.block_size,
                                  cfg.n_kv_heads, cfg.hd, dtype=cfg.tdtype,
                                  device=self.device, mesh=self._mesh)
        self._scratch_block = self.store.pool.alloc(1)[0]  # dummy-row sink
        self.disk = make_disk_store(config.disk_cache_dir,
                                    config.disk_cache_bytes)
        self.metrics = RuntimeMetrics()
        self.metrics.prefill_token_budget = config.max_prefill_tokens
        self.tree = KnowledgeTree(
            config.gpu_cache_bytes, config.host_cache_bytes,
            config.disk_cache_bytes if self.disk is not None else 0,
            policy=config.policy,
            profiler=profiler or CostProfiler.from_fn(
                lambda a, b: 1e-4 * b + 2e-8 * b * (a + b),
                (0, 64, 256, 1024), (1, 32, 128, 512, 1024)),
            backend=(ShardedPagedBackend if tp > 1
                     else PagedBackend)(self.store, self.disk, self.metrics),
            bytes_per_token=max(kv_bytes, 1),
        )
        self.controller = RAGController(self.tree)
        self.spec_ctl = SpeculativeController(config.max_prefill_bs,
                                              enabled=config.speculative)
        self.max_new_tokens = 4       # refined per serve()
        self.admission = PagedAdmission(self.store.pool, self.tree,
                                        decode_reserve=self.max_new_tokens)
        self.sched: ContinuousBatchScheduler[_Job] = ContinuousBatchScheduler(
            SchedulerConfig(max_batch=config.max_batch,
                            max_prefill_bs=config.max_prefill_bs,
                            reorder=config.reorder,
                            reorder_window=reorder_window,
                            prefill_chunk=config.prefill_chunk,
                            max_prefill_tokens=config.max_prefill_tokens),
            viable=self._job_viable, admit=self._job_admissible)
        self._partial_jobs: List[_Job] = []   # jobs with live chunk state
        self._n_slots = 0
        self._n_tbl = 0               # run-table width
        # event loop
        self.now = 0.0
        self._events: List = []
        self._seq = itertools.count()
        self.engine_busy = False
        self.running: List[_ReqRun] = []   # decode-stage requests, FIFO
        self._force_decode = False         # progress guard after a
                                           # pagination failure (see below)
        self._all: List[_ReqRun] = []
        # CAG start-up: pre-insert the FULL corpus KV into the disk tier.
        # Each doc's KV is computed at position 0 with no prefix — what the
        # engine computes for a doc served first — so CAG serves the tokens
        # RAG serves.
        self.preload_stats: Optional[dict] = None
        if self.mode == "cag":
            self.preload_stats = self.controller.preload_corpus(
                range(len(corpus.doc_lengths)), corpus.doc_lengths,
                self._corpus_payload)

    def _corpus_payload(self, doc_id: int, n_tokens: int) -> dict:
        """Host-layout (L, 1, T, KV, hd) {k, v} KV of one corpus doc as CPU
        tensors (bf16 has no numpy type), computed standalone through the
        dense prefill.  The disk tier writes and drops them."""
        toks = self._tensor(np.asarray(self.corpus.doc_tokens[doc_id]))[None]
        _, cache = M.prefill(self.cfg, self.params, toks.long(),
                             attn_impl=self.attn_impl, mesh=self._mesh)
        return {"k": cache["k"].cpu(), "v": cache["v"].cpu()}

    # ------------------------------------------------------------------
    # scheduler callbacks
    # ------------------------------------------------------------------

    def _job_viable(self, job: _Job) -> bool:
        return not job.cancelled and job.req.state == WAITING

    def _job_ctx_beta(self, job: _Job) -> Tuple[int, int, int]:
        """(context, beta, promote) token counts for one job: full sequence,
        to-be-computed tokens, and hit-prefix tokens NOT resident in GPU —
        a pinned path on host/disk still consumes GPU pin budget when the
        prefill promotes it (the admission check must see that)."""
        ctx = (sum(int(self.corpus.doc_lengths[d]) for d in job.docs)
               + len(job.req.r.question_tokens))
        if self.reuse == "chunk":
            cached = promote = 0
            for i, node in enumerate(self.tree.match_chunks(job.docs)):
                if node is None:
                    continue
                n_tok = int(self.corpus.doc_lengths[job.docs[i]])
                if node.exact_ctx and \
                        node.src_prefix == tuple(job.docs[:i]):
                    reused = n_tok
                else:
                    r = effective_recompute(self.recompute_tokens, n_tok,
                                            self.store.block_size)
                    reused = n_tok - r     # 0 when r covers the whole chunk
                cached += reused
                if reused and not node.in_gpu:
                    promote += node.n_tokens   # the whole node promotes
            return ctx, max(ctx - cached, 1), promote
        hit = self.tree.match_prefix(job.docs)
        cached = sum(n.n_tokens for n in hit)
        promote = sum(n.n_tokens for n in hit if not n.in_gpu)
        return ctx, max(ctx - cached, 1), promote

    def _job_admissible(self, job: _Job) -> bool:
        ctx, beta, promote = self._job_ctx_beta(job)
        return self.admission.admissible(ctx, beta, promote)

    def _job_lens(self, job: _Job) -> Tuple[int, int]:
        ctx, beta, _ = self._job_ctx_beta(job)
        return ctx - beta, beta

    # ------------------------------------------------------------------
    # event plumbing
    # ------------------------------------------------------------------

    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    # serve
    # ------------------------------------------------------------------

    def serve(self, requests: Sequence[Request],
              max_new_tokens: int = 4) -> List[RuntimeResult]:
        self.metrics.stamp_serve()
        self.max_new_tokens = max_new_tokens
        self.admission.decode_reserve = max_new_tokens
        max_doc = int(max(self.corpus.doc_lengths))
        max_q = max((len(r.question_tokens) for r in requests), default=8)
        max_ctx = self.top_k * max_doc + max_q + max_new_tokens
        n_slots = self.store.pool.blocks_for_tokens(max_ctx) + 1
        if n_slots > self.store.pool.n_blocks - 1:
            raise ValueError(
                f"paged pool too small: a worst-case request needs "
                f"{n_slots - 1} blocks but the pool has "
                f"{self.store.pool.n_blocks - 1} usable; raise n_blocks or "
                f"lower top_k/doc length")
        if n_slots != self._n_slots:
            self._n_slots = n_slots
            # runs, not a contiguous span: every segment of the slot mapping
            # (<= top_k shared docs + 1 private) may end mid-block, wasting
            # at most one table entry each.  Chunk mode splits a relocated
            # doc into boundary seg + shared tail, so up to 2 entries per doc
            # go to waste instead of 1.
            per_doc = 2 if self.reuse == "chunk" else 1
            self._n_tbl = n_slots + per_doc * self.top_k + 1
            self._warm_up_decode()
        first = len(self._all)
        for r in requests:
            self._push(max(r.arrival, self.now), "arrival", r)
        while self._events:
            self.now, _, kind, payload = heapq.heappop(self._events)
            getattr(self, f"_on_{kind}")(payload)
        unserved = [st.r.req_id for st in self._all[first:]
                    if st.state != FINISHED]
        if unserved:
            raise RuntimeError(
                f"requests {unserved} were never served (admission-starved "
                f"to the end of the event loop — pool or tree budget too "
                f"small for the workload)")
        out = []
        for st in self._all[first:]:
            out.append(RuntimeResult(
                req_id=st.r.req_id, tokens=list(st.tokens), ttft=st.tl.ttft,
                docs=st.final_docs or (), alpha=st.tl.alpha, beta=st.tl.beta,
                speculative_hit=st.tl.speculative_hit,
                exact=st.exact, first_logits=st.first_logits))
        out.sort(key=lambda x: x.req_id)
        return out

    # ------------------------------------------------------------------
    # arrivals & staged retrieval (host-CPU lanes, one per request)
    # ------------------------------------------------------------------

    @_handler_span
    def _on_arrival(self, r: Request) -> None:
        tl = self.metrics.timeline(next(self._seq), self.now)
        tl.req_id = r.req_id
        tl.search_start = self.now
        st = _ReqRun(r=r, tl=tl, spec=SpecState(r.req_id),
                     remaining=self.max_new_tokens)
        self._all.append(st)
        # per-request top_k override (Request.top_k > 0) only ever LOWERS
        # the depth, so the serve()-time max_ctx sizing stays an upper bound
        k = min(r.top_k, self.top_k) if r.top_k > 0 else self.top_k
        if self.mode == "cag":
            # ZERO retrieval stages: the corpus KV is already resident, so
            # doc resolution is one synchronous index probe, no stage
            # events and no speculative prefills run, and the single final
            # job enters the scheduler at arrival
            docs = tuple(int(d) for d in self.index.search(r.query_vec, k))
            st.tl.search_end = self.now
            st.final_docs = docs
            job = _Job(req=st, docs=docs, speculative=False,
                       enqueued=self.now)
            st.jobs.append(job)
            cached, compute = self._job_lens(job)
            self.sched.submit(job, cached, compute)
            self._prefetch_disk(docs)
            st.tl.queue_enter = self.now
            self._engine_kick()
            return
        # materialize stages, measuring the real scan cost of each stage;
        # the per-request search lane advances by max(measured, analytic)
        t = self.now
        n, measured, floor = 0, 0.0, 0.0
        with self.metrics.span("retrieval.search") as sp:
            it = iter(self.index.staged_search(r.query_vec, k))
            while True:
                t0 = time.perf_counter()
                try:
                    stage = next(it)
                except StopIteration:
                    break
                wall = time.perf_counter() - t0
                t += max(wall, stage.seconds) * self.search_time_scale
                self._push(t, "stage", (st, stage))
                n, measured = n + 1, measured + wall
                floor += float(stage.seconds)
            sp.attrs = {"stages": n, "measured_s": measured,
                        "floor_s": floor}

    @_handler_span
    def _on_stage(self, payload) -> None:
        st, stage = payload
        self.metrics.retrieval_stages += 1
        docs = tuple(stage.topk)
        if stage.is_final:
            st.tl.search_end = self.now
            st.final_docs = docs
        action, d = self.spec_ctl.on_stage(
            st.spec, docs, self.sched.pool_size(), is_final=stage.is_final)
        if action in ("terminate_and_launch", "terminate"):
            for job in st.jobs:
                if not job.cancelled and job.docs != docs:
                    job.cancelled = True
        if action in ("launch", "terminate_and_launch"):
            job = _Job(req=st, docs=d, speculative=not stage.is_final,
                       enqueued=self.now)
            st.jobs.append(job)
            cached, compute = self._job_lens(job)
            self.sched.submit(job, cached, compute)
            self._prefetch_disk(d)
            if not stage.is_final:
                self.metrics.spec_prefills += 1
        if stage.is_final:
            if st.tl.queue_enter < 0:
                st.tl.queue_enter = self.now
            self._maybe_finalize(st)
        self._engine_kick()

    def _prefetch_disk(self, docs: Tuple[int, ...]) -> None:
        """Overlap disk reads with the remaining retrieval stages: as soon
        as a stage's top-k is known, stage any disk-only node of the matched
        prefix into host memory.  Host I/O runs concurrently with the
        device, so it does not advance the engine clock."""
        if self.disk is None:
            return
        if self.reuse == "chunk":
            hit = [n for n in self.tree.match_chunks(docs) if n is not None]
        else:
            hit = self.tree.match_prefix(docs)
        pinned = set(hit)   # staging node k must not re-spill node k-1
        for n in hit:
            if n.in_disk and not n.in_host and not n.in_gpu:
                before = self.tree.stats["fetch_bytes"]
                self.tree.fetch_to_host(n, pinned=pinned)
                moved = self.tree.stats["fetch_bytes"] - before
                if moved:
                    self.metrics.disk_prefetches += 1
                    self.metrics.disk_prefetch_bytes += moved

    def _maybe_finalize(self, st: _ReqRun) -> None:
        """Search done: if a prefill for the final docs already completed,
        the speculation paid off — emit the first token now."""
        if st.tl.first_token >= 0 or st.state != WAITING:
            return
        res = st.results.get(st.final_docs)
        if res is not None:
            self._first_token(st, res, max(self.now, st.tl.search_end))

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------

    def _engine_kick(self) -> None:
        while not self.engine_busy:
            self._sweep_stale_partials()
            self.admission.invalidate()   # fresh resource snapshot per kick
            if self._force_decode and self.running:
                # a pagination just failed on shared-block pressure: run one
                # decode iteration first so running requests make progress
                # toward releasing their tables (livelock guard)
                self._force_decode = False
                self._start_decode()
                return
            self._force_decode = False
            act = self.sched.next_action(len(self.running),
                                         refresh=self._job_lens)
            if act.kind == PREFILL:
                self._start_prefill_batch(act.chunks)
                return
            if act.kind == DECODE:
                self._start_decode()
                return
            if act.kind == PREEMPT:
                self._preempt_one()
                continue               # resources freed; re-evaluate
            return                     # IDLE

    def _sweep_stale_partials(self) -> None:
        """Chunk-boundary cancellation: any in-flight chunked prefill whose
        job went stale (terminated speculation, finished request) is aborted
        here — partial KV freed, hit nodes unpinned."""
        for job in [j for j in self._partial_jobs
                    if not self._job_viable(j)]:
            self._abort_chunked(job)

    def _preempt_one(self) -> None:
        """Free the youngest running request and send it back to prefill
        (vLLM-style recompute preemption)."""
        victim = max(self.running, key=lambda s: s.tl.first_token)
        self.running.remove(victim)
        self._release_table(victim)
        victim.state = WAITING
        victim.tokens = []
        victim.remaining = self.max_new_tokens
        stale_res = victim.results.pop(victim.final_docs, None)
        if stale_res is not None:
            self._free_paged_kv(stale_res)
        victim.tl.first_token = -1.0    # recompute re-emits the first token
        victim.tl.token_times = []
        victim.tl.preemptions += 1
        self.metrics.preemptions += 1
        job = _Job(req=victim, docs=victim.final_docs, speculative=False,
                   enqueued=self.now)
        victim.jobs.append(job)
        cached, compute = self._job_lens(job)
        self.sched.submit(job, cached, compute)

    # ---- chunked + batched paged prefill -------------------------------

    def _start_prefill_batch(self, chunks) -> None:
        """One engine iteration: execute the next chunk of every job the
        scheduler packed, as ONE ragged batched paged-prefill call.  Real
        compute is measured (ending in a device synchronise) and billed as
        one iteration on the virtual clock.  Span ``engine.prefill``; its
        ``.plan`` phase is the planning loop, promotions included (the
        dense A/B path computes there too), and ``_run_paged_rows`` takes
        ``.pack``, ``.launch`` and ``.wait``."""
        self.engine_busy = True
        with self.metrics.span("engine.prefill") as step:
            t0 = time.perf_counter()
            outcomes = []                  # (job, finished)
            executed = 0
            rows = []
            with self.metrics.span("engine.prefill.plan"):
                for ch in chunks:
                    job = ch.item
                    if not self._job_viable(job):
                        # went stale in this very event-loop instant;
                        # nothing ran
                        if job.cs is not None:
                            self._abort_chunked(job)
                        else:
                            self.sched.abort_prefill(job)
                        continue
                    if job.cs is None:
                        self._begin_chunked(job)
                    if self.attn == "paged":
                        row = self._prep_paged_chunk(job)
                        if row is None:
                            continue       # OutOfBlocks: job aborted +
                                           # requeued
                        rows.append(row)
                        executed += row[-1]
                    else:
                        n = self._run_chunk(job)
                        if n < 0:
                            continue       # paging the partial KV failed:
                                           # job aborted + requeued in place
                        executed += n
                    outcomes.append((job, not job.cs.pieces))
            if rows:
                self._run_paged_rows(rows)
            dt = time.perf_counter() - t0
            if outcomes:
                self.metrics.record_iteration("prefill", 1)
                self.metrics.record_prefill_batch(len(outcomes), executed)
            self._push(self.now + dt, "prefill_batch_done", outcomes)
            step.attrs = {"rows": len(outcomes), "tokens": executed,
                          "blocks": self._note_pool()}

    def _note_pool(self) -> int:
        """Pool blocks in use now, noted towards the peak."""
        used = self.store.pool.n_blocks - self.store.pool.free_blocks
        self.metrics.pool_blocks_peak = max(self.metrics.pool_blocks_peak,
                                            used)
        return used

    def _begin_chunked(self, job: _Job) -> None:
        """First chunk: plan the request, promote the hit prefix, and build
        the execution cursor.  Paged mode snapshots the prefix's page runs
        (refcount-shared; the nodes stay pinned until commit) and opens one
        empty segment per to-compute segment; dense mode gathers the
        prefix's KV out of the pool."""
        st = job.req
        job.started = self.now
        st.start_by_docs.setdefault(job.docs, self.now)
        doc_tokens = [int(self.corpus.doc_lengths[d]) for d in job.docs]
        if self.reuse == "chunk":
            plan = self.controller.plan_chunks(
                job.docs, doc_tokens, len(st.r.question_tokens),
                recompute_tokens=self.recompute_tokens,
                block_size=self.store.block_size)
        else:
            plan = self.controller.plan(job.docs, doc_tokens,
                                        len(st.r.question_tokens))
        self.controller.promote(plan)   # host->device pull
        if plan.chunks is not None:
            self._begin_chunk_layout(job, plan)
            return
        segs = [np.asarray(self.corpus.doc_tokens[job.docs[i]])
                for i in range(len(plan.hit_nodes), len(job.docs))]
        bounds, start = [], plan.alpha
        for s in segs:
            bounds.append((start, len(s)))
            start += len(s)
        segs.append(np.asarray(st.r.question_tokens))
        pieces = prefill_piece_sizes([len(s) for s in segs],
                                     self.sched.config.prefill_chunk)
        if not pieces:
            raise ValueError(
                f"request {st.r.req_id}: nothing to prefill (empty question "
                f"and fully cached documents) — no logits can be produced")
        if self.attn == "dense":
            prefix_hit, plen = self._assemble_prefix(plan.hit_nodes)
            job.cs = _ChunkState(plan=plan, segs=segs, doc_bounds=bounds,
                                 pieces=pieces, plen=plen,
                                 prefix_hit=prefix_hit)
            self._partial_jobs.append(job)
            return
        hit_runs, layout, plen = [], [], 0
        for node in plan.hit_nodes:
            seg = node.payload_gpu
            self.store.share(seg)
            layout.append(("run", len(hit_runs), plen))
            hit_runs.append((list(seg.blocks), seg.n_tokens))
            plen += seg.n_tokens
        seg_abs, pos = [], plen
        for i, s in enumerate(segs):
            seg_abs.append(pos)
            layout.append(("seg", i, pos))
            pos += len(s)
        job.cs = _ChunkState(plan=plan, segs=segs, doc_bounds=bounds,
                             pieces=pieces, plen=plen)
        job.cs.hit_runs = hit_runs
        job.cs.layout = layout
        job.cs.seg_abs = seg_abs
        job.cs.pg_segs = [PagedSegment(self.store, [], 0) for _ in segs]
        self._partial_jobs.append(job)

    def _begin_chunk_layout(self, job: _Job, plan) -> None:
        """Chunk-cache twin of the prefix begin path (--reuse chunk): the
        request's sequence is an ordered interleaving of shared cached runs
        and to-compute segments.  Per doc position (ChunkItem):

          * exact — share the node's pages whole, like a prefix hit;
          * reloc — an owned boundary segment of ``recompute`` tokens (the
            doc head, recomputed at its new absolute position over the true
            preceding context) followed by the node's page-aligned tail
            pages, refcount-shared in place (stale RoPE — approximate);
          * miss — an owned segment computing the whole doc.

        The question is the final owned segment.  Compute segments sit at
        scattered absolute offsets, so each records its start (seg_abs)."""
        st = job.req
        bs = self.store.block_size
        segs: List[np.ndarray] = []
        seg_abs: List[int] = []
        layout: List[Tuple[str, int, int]] = []
        hit_runs: List[Tuple[List[int], int]] = []
        miss_segs: List[int] = []
        pos = 0
        for it in plan.chunks:
            if it.kind == "exact":
                seg = it.node.payload_gpu
                self.store.share(seg)
                layout.append(("run", len(hit_runs), pos))
                hit_runs.append((list(seg.blocks), seg.n_tokens))
                self.metrics.exact_chunk_hits += 1
            elif it.kind == "reloc":
                toks = np.asarray(self.corpus.doc_tokens[it.doc_id])
                segs.append(toks[:it.recompute])
                seg_abs.append(pos)
                layout.append(("seg", len(segs) - 1, pos))
                # recompute is page-aligned (effective_recompute), so the
                # reused tail starts at slot 0 of a block — the run-table /
                # decode-run contract every shared run must satisfy
                tail = list(it.node.payload_gpu.blocks[it.recompute // bs:])
                self.store.share_blocks(tail)
                layout.append(("run", len(hit_runs), pos + it.recompute))
                hit_runs.append((tail, it.n_tokens - it.recompute))
                self.metrics.reloc_chunk_hits += 1
                self.metrics.reloc_recompute_tokens += it.recompute
            else:
                segs.append(np.asarray(self.corpus.doc_tokens[it.doc_id]))
                seg_abs.append(pos)
                layout.append(("seg", len(segs) - 1, pos))
                miss_segs.append(len(segs) - 1)
            pos += it.n_tokens
        segs.append(np.asarray(st.r.question_tokens))
        seg_abs.append(pos)
        layout.append(("seg", len(segs) - 1, pos))
        seg_lens = [len(s) for s in segs]
        chunk = self.sched.config.prefill_chunk
        if chunk > 0:
            pieces = prefill_piece_sizes(seg_lens, chunk)
        else:
            # one piece per segment even unchunked: a piece's query rows are
            # consecutive absolute positions (the kernel's q_start
            # contract), and here compute segments are separated by shared
            # runs
            pieces = [int(n) for n in seg_lens if n > 0]
        if not pieces:
            raise ValueError(
                f"request {st.r.req_id}: nothing to prefill (empty question "
                f"and fully cached documents) — no logits can be produced")
        job.cs = _ChunkState(plan=plan, segs=segs, doc_bounds=[],
                             pieces=pieces, plen=plan.alpha)
        job.cs.hit_runs = hit_runs
        job.cs.layout = layout
        job.cs.seg_abs = seg_abs
        job.cs.miss_segs = miss_segs
        job.cs.pg_segs = [PagedSegment(self.store, [], 0) for _ in segs]
        self._partial_jobs.append(job)

    def _chunk_prefix(self, cs: _ChunkState) -> Tuple[Optional[dict], int]:
        """KV prefix for the next dense piece: the cached prefix alone on
        the first iteration, plus the partial KV gathered back out of the
        pool on continuation iterations."""
        if cs.partial_seg is None:
            return cs.prefix_hit, cs.plen
        k, v = self.store.gather(cs.partial_seg)
        if cs.prefix_hit is None:
            return {"k": k, "v": v}, cs.plen
        return {"k": torch.cat([cs.prefix_hit["k"], k], dim=2),
                "v": torch.cat([cs.prefix_hit["v"], v], dim=2)}, cs.plen

    def _run_chunk(self, job: _Job) -> int:
        """Execute the next piece of ``job``'s dense prefill.  A piece never
        spans a segment boundary when chunking is on; with chunking off the
        single piece walks every segment.  Returns tokens computed, or -1
        if paging the partial KV failed and the job was aborted +
        requeued."""
        cs = job.cs
        n = cs.pieces.pop(0)
        multi_iter = bool(cs.pieces) or cs.partial_seg is not None
        prefix, plen = self._chunk_prefix(cs)
        plen0, left = plen, n
        logits = cache = None
        while left > 0:
            seg = cs.segs[cs.seg_idx]
            take = min(left, len(seg) - cs.seg_off)
            toks = self._tensor(np.asarray(
                seg[cs.seg_off:cs.seg_off + take], np.int64))[None]
            logits, cache = M.prefill(self.cfg, self.params, toks, prefix,
                                      plen, attn_impl=self.attn_impl,
                                      mesh=self._mesh)
            prefix, plen = cache, plen + take
            cs.seg_off += take
            left -= take
            while cs.seg_idx < len(cs.segs) and \
                    cs.seg_off >= len(cs.segs[cs.seg_idx]):
                cs.seg_idx += 1
                cs.seg_off = 0
        last = logits[0, -1]
        cs.first_token = int(last.argmax())
        cs.logits = last.cpu().numpy()
        self.store.sync()
        cs.plen = plen
        if not cs.pieces or not multi_iter:
            # final piece (or single-iteration prefill): the carried cache
            # is the full sequence — kept dense for commit / paginate
            cs.cache = cache
            return n
        # page the newly computed KV into the store, so the only live copy
        # of the partial prefill is paged (cancellation frees it)
        k = cache["k"][:, :, plen0:plen]
        v = cache["v"][:, :, plen0:plen]
        if not self._reclaim_blocks(
                self.store.pool.blocks_for_tokens(plen - plen0)):
            self._abort_chunked(job, requeue=True)
            return -1
        try:
            if cs.partial_seg is None:
                cs.partial_seg = self.store.put(k, v)
            else:
                self.store.append(cs.partial_seg, k, v)
        except OutOfBlocks:
            self._abort_chunked(job, requeue=True)
            return -1
        return n

    def _prep_paged_chunk(self, job: _Job):
        """Allocate pages for the next piece of ``job`` and build its row of
        the ragged batch: chunk tokens, their (block, slot) write coords,
        and the run table covering cached prefix + everything computed so
        far INCLUDING this chunk (causal masking over absolute positions
        keeps row i from seeing slots past it).  Returns None if the pool
        cannot hold the piece (job aborted + requeued in place)."""
        cs = job.cs
        n = cs.pieces.pop(0)
        while cs.seg_idx < len(cs.segs) and \
                cs.seg_off >= len(cs.segs[cs.seg_idx]):
            cs.seg_idx += 1          # skip empty segments before anchoring
            cs.seg_off = 0
        # the piece's rows are consecutive absolute positions anchored at
        # the cursor's segment (chunk mode scatters compute segments between
        # shared runs, so a running prefix length is not the position)
        q_start = cs.seg_abs[cs.seg_idx] + cs.seg_off
        toks = np.zeros(n, np.int32)
        wblk = np.full(n, self._scratch_block, np.int32)
        wslot = np.zeros(n, np.int32)
        off, left = 0, n
        while left > 0:
            seg = cs.segs[cs.seg_idx]
            pg = cs.pg_segs[cs.seg_idx]
            take = min(left, len(seg) - cs.seg_off)
            need = (self.store.pool.blocks_for_tokens(pg.n_tokens + take)
                    - len(pg.blocks))
            if need > 0 and not self._reclaim_blocks(need):
                self._abort_chunked(job, requeue=True)
                return None
            try:
                blk, slot = self.store.extend_alloc(pg, take)
            except OutOfBlocks:
                self._abort_chunked(job, requeue=True)
                return None
            toks[off:off + take] = seg[cs.seg_off:cs.seg_off + take]
            wblk[off:off + take] = blk
            wslot[off:off + take] = slot
            cs.seg_off += take
            off += take
            left -= take
            while cs.seg_idx < len(cs.segs) and \
                    cs.seg_off >= len(cs.segs[cs.seg_idx]):
                cs.seg_idx += 1
                cs.seg_off = 0
        cs.plen += n
        tables, counts, starts = self._paged_chunk_row(cs)
        return (job, toks, wblk, wslot, q_start, tables, counts, starts, n)

    def _paged_chunk_row(self, cs: _ChunkState):
        """Run-table row over the ordered sequence layout, same contract as
        decode (kernels/paged_attention.py): every entry starts at slot 0 of
        a fresh block, so runs are exactly the per-block spans.  Each entry
        carries its true absolute start — with chunk-mode interleaving, a
        shared run can sit past a partially filled compute segment, and
        causal masking over absolute positions (not table order) is what
        keeps those later keys invisible to this piece's rows."""
        T = self._n_tbl
        bs = self.store.block_size
        tables = np.full(T, self._scratch_block, np.int32)
        counts = np.zeros(T, np.int32)
        starts = np.zeros(T, np.int32)
        j = 0
        for kind, idx, abs0 in cs.layout:
            if kind == "run":
                blocks, ntok = cs.hit_runs[idx]
            else:
                pg = cs.pg_segs[idx]
                blocks, ntok = pg.blocks, pg.n_tokens
            for bi, blk in enumerate(blocks):
                c = min(bs, ntok - bi * bs)
                if c <= 0:
                    break
                tables[j] = blk
                counts[j] = c
                starts[j] = abs0 + bi * bs
                j += 1
        assert j <= T, (j, T)
        return tables, counts, starts

    def _run_paged_rows(self, rows) -> None:
        """Execute one ragged batched paged-prefill iteration.  Rows pad to
        ``max_prefill_bs`` and chunk lengths to a power-of-two bucket (>= 8),
        the shapes a captured CUDA graph could replay; padding rows/tokens
        write into the scratch block and are fully masked (q_len), so every
        real row's output is independent of what shares the batch."""
        m = self.metrics
        with m.span("engine.prefill.pack"):
            B = max(self.sched.config.max_prefill_bs, len(rows))
            Sq = max(8, 1 << (max(r[-1] for r in rows) - 1).bit_length())
            T = self._n_tbl
            toks = np.zeros((B, Sq), np.int32)
            wblk = np.full((B, Sq), self._scratch_block, np.int32)
            wslot = np.zeros((B, Sq), np.int32)
            tables = np.full((B, T), self._scratch_block, np.int32)
            counts = np.zeros((B, T), np.int32)
            starts = np.zeros((B, T), np.int32)
            q_start = np.zeros((B,), np.int32)
            q_len = np.zeros((B,), np.int32)
            for i, (job, t, wb, ws, qs, tb, cn, st_, n) in enumerate(rows):
                toks[i, :n] = t
                wblk[i, :n] = wb
                wslot[i, :n] = ws
                tables[i] = tb
                counts[i] = cn
                starts[i] = st_
                q_start[i] = qs
                q_len[i] = n
        with m.span("engine.prefill.launch") as sp:
            logits = M.paged_prefill_step(
                self.cfg, self.params, self._tensor(toks),
                self.store.k_planes, self.store.v_planes,
                self._tensor(tables), self._tensor(counts),
                self._tensor(starts), self._tensor(q_start),
                self._tensor(q_len), self._tensor(wblk), self._tensor(wslot),
                attn_impl=self.attn_impl, mesh=self._mesh)
            sp.attrs = {"B": B, "Sq": Sq}
        with m.span("engine.prefill.wait"):
            last = logits[:len(rows), -1]                   # (n_rows, V)
            first = last.argmax(dim=-1).cpu().numpy()
            host = last.cpu().numpy()
            self.store.sync()
        for i, row in enumerate(rows):
            row[0].cs.first_token = int(first[i])
            row[0].cs.logits = host[i]

    @_handler_span
    def _on_prefill_batch_done(self, payload) -> None:
        self.engine_busy = False
        for job, finished in payload:
            st = job.req
            cs = job.cs
            if cs is None:
                continue               # aborted mid-iteration (requeue path)
            stale = job.cancelled or st.state != WAITING
            if not finished:
                if stale:
                    self._abort_chunked(job)
                else:
                    self.sched.note_chunk_done(job, cs.pieces)
                continue
            # prefill complete
            self.sched.note_chunk_done(job, [])
            pg_segs, hit_runs = cs.pg_segs, cs.hit_runs
            if not stale:
                # ownership of the paged state moves to the result BEFORE
                # _drop_chunk_state (which frees whatever is still attached)
                cs.pg_segs, cs.hit_runs = [], []
            self._drop_chunk_state(job)
            if stale:
                for n in cs.plan.hit_nodes:   # unpin without committing
                    n.pinned = False
                self.metrics.wasted_prefills += 1
                self.metrics.wasted_prefill_tokens += sum(
                    len(s) for s in cs.segs)
                continue
            res = _PrefillResult(
                docs=job.docs, cache=cs.cache, first_token=cs.first_token,
                total_len=cs.plen,
                alpha=cs.plan.alpha, beta=cs.plan.beta,
                hit_docs=cs.plan.hit_docs,
                hit_tier_tokens=cs.plan.hit_tier_tokens,
                speculative=job.speculative, started=job.started,
                hit_runs=hit_runs, pg_segs=pg_segs,
                layout=list(cs.layout), exact=cs.plan.exact,
                first_logits=cs.logits)
            if cs.plan.chunks is not None:
                self._commit_paged_chunks(
                    cs.plan, [pg_segs[i] for i in cs.miss_segs])
            elif self.attn == "paged":
                self._commit_paged(cs.plan, pg_segs[:len(cs.doc_bounds)])
            else:
                self._commit_payloads(
                    cs.plan, [(start, length, cs.cache)
                              for start, length in cs.doc_bounds])
            st.results[job.docs] = res
            if st.final_docs is not None and job.docs == st.final_docs:
                self._first_token(st, res, max(self.now, st.tl.search_end))
        self._engine_kick()

    def _drop_chunk_state(self, job: _Job) -> None:
        cs = job.cs
        if cs is not None:
            if cs.partial_seg is not None:
                self.store.free(cs.partial_seg)
                cs.partial_seg = None
            self._free_paged_kv(cs)
        job.cs = None
        if job in self._partial_jobs:
            self._partial_jobs.remove(job)

    def _free_paged_kv(self, holder) -> None:
        """Drop a _ChunkState's or _PrefillResult's paged KV references:
        release the shared hit runs (one incref each) and free the owned
        segments.  No-op once ownership has transferred (lists emptied)."""
        for blocks, _ in holder.hit_runs:
            self.store.release(blocks)
        holder.hit_runs = []
        for pg in holder.pg_segs:
            if pg.blocks:
                self.store.free(pg)
        holder.pg_segs = []

    def _abort_chunked(self, job: _Job, requeue: bool = False) -> None:
        """Mid-prefill cancellation: free the partial KV, unpin the hit
        prefix, and account the chunk tokens that were never computed."""
        cs = job.cs
        saved = sum(cs.pieces) if cs is not None else 0
        computed = sum(len(s) for s in cs.segs) - saved if cs else 0
        if cs is not None:
            for n in cs.plan.hit_nodes:
                n.pinned = False
        self._drop_chunk_state(job)
        self.sched.abort_prefill(job)
        if not requeue:
            # a requeued job recomputes everything later — only genuine
            # cancellations (stale speculation / finished request) save work
            self.metrics.record_chunk_cancel(saved)
            self.metrics.wasted_prefill_tokens += computed
        if requeue:
            # paged-pool pressure, not staleness: recompute later — force a
            # decode iteration first so running requests free blocks
            job.cancelled = True
            self._force_decode = True
            redo = _Job(req=job.req, docs=job.docs,
                        speculative=job.speculative, enqueued=self.now)
            job.req.jobs.append(redo)
            cached, compute = self._job_lens(redo)
            self.sched.submit(redo, cached, compute)

    def _commit_payloads(self, plan, payloads) -> None:
        """Dense mode: page the new per-doc KV segments into the store and
        insert them into the knowledge tree; stop caching at the first doc
        the pool cannot hold."""
        segs = []
        for start, length, cache in payloads:
            k = cache["k"][:, :, start:start + length]
            v = cache["v"][:, :, start:start + length]
            if not self._reclaim_blocks(
                    self.store.pool.blocks_for_tokens(length)):
                break
            try:
                segs.append(self.store.put(k, v))
            except OutOfBlocks:
                break
        inserted = self.controller.commit(
            plan, segs, max_docs=len(plan.hit_nodes) + len(segs))
        # free every segment the tree did not take: the tail when insert
        # stopped early, and duplicates of a doc path committed first
        kept = {id(n.payload_gpu) for n in inserted}
        for seg in segs:
            if id(seg) not in kept:
                self.store.free(seg)

    def _commit_paged(self, plan, doc_segs) -> None:
        """Paged mode: the per-doc KV already lives in pool blocks (the
        prefill step scattered it in place), so committing is pure
        refcounting — share each segment to mint the tree's independent
        reference, then drop it again for every segment the tree declined
        (duplicate doc path or insert stopped early)."""
        for seg in doc_segs:
            self.store.share(seg)
        inserted = self.controller.commit(
            plan, list(doc_segs), max_docs=len(plan.hit_nodes) + len(doc_segs))
        kept = {id(n.payload_gpu) for n in inserted}
        for seg in doc_segs:
            if id(seg) not in kept:
                self.store.release(seg.blocks)

    def _commit_paged_chunks(self, plan, doc_segs) -> None:
        """Chunk-mode commit (--reuse chunk): only miss docs enter the flat
        chunk cache — the canonical entry for an exact/reloc hit is the node
        already resident, and relocated boundary segments stay request-
        private (their KV is position-specific).  Pure refcounting like
        ``_commit_paged``; declined segments return their extra ref."""
        for seg in doc_segs:
            self.store.share(seg)
        inserted = self.controller.commit_chunks(plan, list(doc_segs))
        kept = {id(n.payload_gpu) for n in inserted}
        for seg in doc_segs:
            if id(seg) not in kept:
                self.store.release(seg.blocks)

    def _reclaim_blocks(self, needed: int) -> bool:
        """Evict unpinned tree leaves (PGDSF order, shared Alg. 1 loop)
        until the pool has ``needed`` free blocks."""
        try:
            self.tree.evict_gpu_until(
                lambda: self.store.pool.free_blocks >= needed)
            return True
        except EvictionError:
            return False

    def _assemble_prefix(self, nodes) -> Tuple[Optional[dict], int]:
        """Dense mode: the hit nodes' KV gathered out of the pool and
        concatenated, (L, 1, alpha, KV, hd) each."""
        if not nodes:
            return None, 0
        ks, vs = [], []
        for n in nodes:
            k, v = self.store.gather(n.payload_gpu)
            ks.append(k)
            vs.append(v)
        k = torch.cat(ks, dim=2)
        return {"k": k, "v": torch.cat(vs, dim=2)}, int(k.shape[2])

    # ---- first token & decode admission --------------------------------

    def _first_token(self, st: _ReqRun, res: _PrefillResult, t: float) -> None:
        tl = st.tl
        tl.first_token = t
        tl.prefill_end = t
        tl.alpha, tl.beta = res.alpha, res.beta
        tl.hit_docs = res.hit_docs
        (tl.hit_tokens_gpu, tl.hit_tokens_host,
         tl.hit_tokens_disk) = res.hit_tier_tokens
        tl.n_docs = len(res.docs)
        tl.docs = res.docs
        tl.speculative_hit = res.speculative or res.started < tl.search_end
        start = st.start_by_docs.get(res.docs)
        if start is not None:
            tl.final_prefill_start = start
        st.tokens = [res.first_token]
        st.exact = res.exact
        st.first_logits = res.first_logits
        st.remaining = self.max_new_tokens - 1
        for job in st.jobs:            # any other pending work is now moot
            if not job.cancelled and job.docs != res.docs:
                job.cancelled = True
        if st.remaining <= 0:
            self._finish(st, t)
            return
        if not self._paginate(st, res):
            # pool pressure raced us between admission and join: retry later
            self._requeue_after_pagination_failure(st)
            return
        st.state = RUNNING
        st.last_tok = res.first_token
        self.running.append(st)

    def _requeue_after_pagination_failure(self, st: _ReqRun) -> None:
        res = st.results.pop(st.final_docs, None)
        if res is not None:
            self._free_paged_kv(res)
        st.tokens = []
        st.tl.first_token = -1.0       # not actually servable yet
        self._force_decode = True      # guarantee decode progress before
                                       # this job can be re-popped
        job = _Job(req=st, docs=st.final_docs, speculative=False,
                   enqueued=self.now)
        st.jobs.append(job)
        cached, compute = self._job_lens(job)
        self.sched.submit(job, cached, compute)

    def _paginate(self, st: _ReqRun, res: _PrefillResult) -> bool:
        if self.attn == "paged":
            return self._paginate_paged(st, res)
        return self._paginate_dense(st, res)

    def _paginate_dense(self, st: _ReqRun, res: _PrefillResult) -> bool:
        """Dense mode: refcount-share every complete GPU-resident tree
        prefix node (block-aligned or not: the token-level slot mapping
        absorbs unaligned doc tails) and copy the rest (uncached docs +
        question) into private blocks with the decode reserve."""
        bs = self.store.block_size
        pos_blk: List[int] = []
        pos_slot: List[int] = []
        shared: List[int] = []
        offset = 0
        for node in self.tree.match_prefix(res.docs):
            seg = node.payload_gpu
            if (seg is None or not node.in_gpu
                    or seg.n_tokens != node.n_tokens):
                break
            self.store.share(seg)
            for i in range(seg.n_tokens):
                pos_blk.append(seg.blocks[i // bs])
                pos_slot.append(i % bs)
            shared.extend(seg.blocks)
            offset += seg.n_tokens
        rest = res.total_len - offset
        k = res.cache["k"][:, :, offset:res.total_len]
        v = res.cache["v"][:, :, offset:res.total_len]
        need = self.store.pool.blocks_for_tokens(rest + st.remaining)
        if not self._reclaim_blocks(need):
            self.store.release(shared)
            return False
        try:
            priv = self.store.put(k, v, reserve_tokens=st.remaining)
        except OutOfBlocks:
            self.store.release(shared)
            return False
        for i in range(rest + st.remaining):
            pos_blk.append(priv.blocks[i // bs])
            pos_slot.append(i % bs)
        st.pos_blk, st.pos_slot = pos_blk, pos_slot
        st.owned_blocks = shared + priv.blocks
        st.length = res.total_len
        self.metrics.blocks_shared += len(shared)
        self.metrics.blocks_copied += len(priv.blocks)
        return True

    def _paginate_paged(self, st: _ReqRun, res: _PrefillResult) -> bool:
        """Paged mode: every token already sits
        in a pool block — the cached prefix in the shared hit runs, the rest
        in the result's owned segments — so this is pure bookkeeping plus
        one allocation-only extension of the question segment for the
        decode reserve.  On success the result's references transfer
        wholesale to ``st.owned_blocks`` (lists emptied); on failure ``res``
        is left untouched for the requeue path to free."""
        bs = self.store.block_size
        qseg = res.pg_segs[-1]
        need = (self.store.pool.blocks_for_tokens(qseg.n_tokens + st.remaining)
                - len(qseg.blocks))
        if need > 0 and not self._reclaim_blocks(need):
            return False
        try:
            self.store.extend_alloc(qseg, st.remaining)
        except OutOfBlocks:
            return False
        pos_blk: List[int] = []
        pos_slot: List[int] = []
        shared: List[int] = []
        owned: List[int] = []
        # the layout lists entries in absolute position order, so appending
        # yields the position -> (block, slot) mapping
        for kind, idx, _ in res.layout:
            if kind == "run":
                blocks, n_tokens = res.hit_runs[idx]
                for i in range(n_tokens):
                    pos_blk.append(blocks[i // bs])
                    pos_slot.append(i % bs)
                shared.extend(blocks)
            else:
                pg = res.pg_segs[idx]
                for i in range(pg.n_tokens):
                    pos_blk.append(pg.blocks[i // bs])
                    pos_slot.append(i % bs)
                owned.extend(pg.blocks)
        st.pos_blk, st.pos_slot = pos_blk, pos_slot
        st.owned_blocks = shared + owned
        st.length = res.total_len
        self.metrics.blocks_shared += len(shared)
        self.metrics.blocks_copied += len(owned)
        res.pg_segs, res.hit_runs = [], []    # ownership moved to the table
        return True

    def _release_table(self, st: _ReqRun) -> None:
        if st.owned_blocks:
            self.store.release(st.owned_blocks)
        st.pos_blk, st.pos_slot, st.owned_blocks = [], [], []
        st.length = 0

    # ---- batched paged decode ------------------------------------------

    def _warm_up_decode(self) -> None:
        """Run the single decode shape once before serving (dummy rows
        decode token 0 into the scratch block, exactly like a padding row),
        so one-time device set-up never lands on the serving clock, nor in
        the spans (its own go to a scratch ``RuntimeMetrics``)."""
        serving, self.metrics = self.metrics, RuntimeMetrics()
        try:
            self._decode([])
        finally:
            self.metrics = serving

    def _decode(self, batch) -> np.ndarray:
        """One batched decode iteration; returns the next token of every
        row (padding rows included).  Span ``engine.decode``: ``.pack``
        the run tables, ``.launch`` the step, ``.wait`` the next tokens'
        readback and the synchronise."""
        m = self.metrics
        with m.span("engine.decode") as step:
            if self.attn == "paged":
                with m.span("engine.decode.pack"):
                    (toks, tables, counts, starts, pos, write_blk,
                     write_slot) = self._paged_decode_args(batch)
                with m.span("engine.decode.launch"):
                    logits = M.paged_decode_step(
                        self.cfg, self.params, toks, self.store.k_planes,
                        self.store.v_planes,
                        tables, counts, starts, write_blk, write_slot, pos,
                        attn_impl=self.attn_impl, mesh=self._mesh)
            else:
                with m.span("engine.decode.pack"):
                    args = self._dense_decode_args(batch)
                with m.span("engine.decode.launch"):
                    logits = self._dense_decode(*args)
            with m.span("engine.decode.wait"):
                next_toks = logits[:, -1].argmax(dim=-1).cpu().numpy()
                self.store.sync()
            step.attrs = {"rows": len(batch),
                          "longest": max((st.length + 1 for st in batch),
                                         default=0),
                          "blocks": self._note_pool()}
        return next_toks

    def _dense_decode(self, toks, blk_map, slot_map, lengths):
        """Dense mode: gather every row's sequence out of the pool by its
        token-level slot mapping — position p of row b lives at
        (blk_map[b, p], slot_map[b, p]), so the gathered cache is hole-free
        even where shared tree segments end mid-block — decode over it, and
        write the new token's K/V back into the pool."""
        k, v = self.store.read_slots(blk_map, slot_map)  # (L, B, S, KV, hd)
        cache = {"k": k, "v": v}
        logits = M.decode_step(self.cfg, self.params, toks, cache,
                               lengths + 1, mesh=self._mesh)
        bidx = torch.arange(toks.shape[0], device=self.device)
        at = lengths.long()
        blk, slot = blk_map[bidx, at], slot_map[bidx, at]
        self.store.write_slots(blk, slot, k[:, bidx, at], v[:, bidx, at])
        return logits

    def _dense_decode_args(self, batch):
        B = self.sched.config.max_batch
        S = self._n_slots * self.store.block_size   # max token positions
        toks = np.zeros((B, 1), np.int64)
        blk_map = np.full((B, S), self._scratch_block, np.int64)
        slot_map = np.zeros((B, S), np.int64)
        lengths = np.zeros((B,), np.int32)
        for i, st in enumerate(batch):
            toks[i, 0] = st.last_tok
            blk_map[i, :len(st.pos_blk)] = st.pos_blk
            slot_map[i, :len(st.pos_slot)] = st.pos_slot
            lengths[i] = st.length
        return tuple(self._tensor(a) for a in (toks, blk_map, slot_map,
                                               lengths))

    def _paged_decode_args(self, batch):
        """Pack the run tables for one paged decode iteration.  Contract
        (kernels/paged_attention.py): the slot mapping is a list of runs,
        each starting at slot 0 of its block — run boundaries are exactly
        the positions with pos_slot == 0."""
        B = self.sched.config.max_batch
        T = self._n_tbl
        toks = np.zeros((B, 1), np.int32)
        tables = np.full((B, T), self._scratch_block, np.int32)
        counts = np.zeros((B, T), np.int32)
        starts = np.zeros((B, T), np.int32)
        pos = np.ones((B,), np.int32)
        write_blk = np.full((B,), self._scratch_block, np.int32)
        write_slot = np.zeros((B,), np.int32)
        counts[:, 0] = 1               # dummy rows attend their scratch write
        for i, st in enumerate(batch):
            n = st.length + 1          # incl. the token decoded this step
            blk = np.asarray(st.pos_blk[:n], np.int32)
            slot = np.asarray(st.pos_slot[:n], np.int32)
            run = np.flatnonzero(slot == 0)
            assert len(run) <= T, (len(run), T)
            counts[i] = 0
            tables[i, :len(run)] = blk[run]
            counts[i, :len(run)] = np.diff(np.append(run, n))
            starts[i, :len(run)] = run
            pos[i] = n
            toks[i, 0] = st.last_tok
            write_blk[i] = st.pos_blk[st.length]
            write_slot[i] = st.pos_slot[st.length]
        return tuple(self._tensor(a) for a in (toks, tables, counts, starts,
                                               pos, write_blk, write_slot))

    def _start_decode(self) -> None:
        batch = self.running[:self.sched.config.max_batch]
        self.engine_busy = True
        self.metrics.record_iteration("decode", len(batch))
        t0 = time.perf_counter()
        next_toks = self._decode(batch)
        dt = time.perf_counter() - t0
        self._push(self.now + dt, "decode_done",
                   (batch, [int(t) for t in next_toks[:len(batch)]]))

    @_handler_span
    def _on_decode_done(self, payload) -> None:
        batch, toks = payload
        self.engine_busy = False
        for st, tok in zip(batch, toks):
            if st.state != RUNNING:     # preempted meanwhile
                continue
            st.tokens.append(tok)
            st.last_tok = tok
            st.length += 1
            st.remaining -= 1
            st.tl.token_times.append(self.now)
            if st.remaining <= 0:
                self.running.remove(st)
                self._release_table(st)
                self._finish(st, self.now)
        self._engine_kick()

    def _finish(self, st: _ReqRun, t: float) -> None:
        st.state = FINISHED
        st.tl.finish = t
        st.tl.tokens = list(st.tokens)
        for job in st.jobs:
            job.cancelled = True
        # drop the prefill results (incl. wasted speculations) — the paged
        # store/tree is the only KV owner after a request completes; paged
        # results still hold refcounts that must be returned to the pool
        for res in st.results.values():
            self._free_paged_kv(res)
        st.results = {}
        st.jobs = []
