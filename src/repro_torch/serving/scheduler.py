"""Iteration-level continuous-batching scheduler (vLLM/Orca-style) with
chunk-granular prefill.

One decision per engine iteration: run a PREFILL iteration (a *batch* of
prefill chunks — continuations of in-flight chunked prefills plus newly
admitted jobs, packed raggedly up to ``max_prefill_tokens``) or ONE batched
decode step for every running request.  Prefill is preferred while the
decode batch has room — it adds a request to the batch, which is what keeps
the GPU busy under load — and decode drains the batch otherwise.

Chunked prefill (Sarathi-style, paper Alg. 2 "terminate after the current
iteration"): a prefill is split into ``prefill_chunk``-token pieces and the
engine carries the KV across iterations.  Between chunks the scheduler
re-decides, so stale speculation is cancelled mid-prefill (the engine frees
the partial KV) instead of wasting the whole prefill, and decode interleaves
with long prefills.  Chunk pieces NEVER span segment (document/question)
boundaries — see ``prefill_piece_sizes`` — which keeps every per-segment
attention call shape-identical to the unchunked engine and therefore the
greedy tokens bit-identical.

The scheduler is engine-agnostic: queue items are opaque; the engine supplies
``viable`` (not cancelled / request not finished) and ``admit`` (resource
admission) callbacks.  Both the real JAX runtime (``serving.runtime``) and
the discrete-event simulator (``serving.simulator``) drive THIS code, so the
simulated policy and the executed policy cannot drift.

Chunk protocol: ``next_action`` returns ``Action(PREFILL, chunks=[...])``.
Each ``PrefillChunk`` is a token allowance for one item; ``first=True``
means the engine has not started this item yet (it must plan the request
and report the authoritative remaining piece sizes).  After executing a
chunk the engine calls ``note_chunk_done(item, remaining_pieces)`` (empty =
prefill complete) or ``abort_prefill(item)`` if the item went stale at the
chunk boundary.  Until the first report, a popped item is tracked as a
partial with unknown pieces and is not re-issued.

Admission control is by paged-KV-block budget and knowledge-tree pin budget
(``PagedAdmission``); admission is checked once, when a job's FIRST chunk is
admitted — a partial prefill already holds its resources, so continuations
bypass admission (finishing is the only way to release them).  When an
admissible-resource-starved request has been skipped ``preempt_after_skips``
times, the scheduler asks the engine to preempt (engine picks the victim —
youngest running request — frees its blocks, and requeues it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Generic, List, Optional, Sequence, TypeVar

from repro_torch.core.reorder import ReorderQueue

T = TypeVar("T")

PREFILL = "prefill"
DECODE = "decode"
PREEMPT = "preempt"
IDLE = "idle"


def prefill_piece_sizes(seg_lens: Sequence[int], chunk: int) -> List[int]:
    """Split a prefill into per-iteration piece sizes (tokens).

    seg_lens: token count of each to-be-computed segment, in order (uncached
    documents, then the question).  chunk <= 0 disables chunking: the whole
    prefill is one piece (one engine iteration, the legacy behaviour).

    With chunking enabled, every segment is split independently into
    ceil(len/chunk) pieces — pieces never span a segment boundary, so the
    attention calls that compute a given document's KV are a pure function
    of (document length, chunk size), independent of how much prefix was
    cached.  That is what keeps chunked greedy tokens bit-identical to the
    unchunked engine.

    Shared by the runtime, the simulator and the sequential engine — the
    single source of chunk boundaries (no duplicated chunking logic).
    """
    lens = [int(n) for n in seg_lens if n > 0]
    if not lens:
        return []
    if chunk <= 0:
        return [sum(lens)]
    out: List[int] = []
    for n in lens:
        out.extend([chunk] * (n // chunk))
        if n % chunk:
            out.append(n % chunk)
    return out


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 4             # decode batch slots (paper testbed: 4)
    max_prefill_bs: int = 4        # DSP speculative-prefill pool bound
    reorder: bool = True           # cache-aware reordering (§5.2)
    reorder_window: int = 32       # starvation window
    preempt_after_skips: int = 8   # admission-starved skips before preemption
    prefill_chunk: int = 0         # tokens per prefill piece (0 = whole
                                   # prefill in one engine iteration)
    max_prefill_tokens: int = 0    # ragged prefill-batch token budget per
                                   # iteration (0 = one request per iteration)


@dataclasses.dataclass
class PrefillChunk(Generic[T]):
    item: T
    tokens: int                    # planned token allowance this iteration
    first: bool                    # engine must plan the request (chunk 0)


@dataclasses.dataclass
class Action(Generic[T]):
    kind: str                      # PREFILL | DECODE | PREEMPT | IDLE
    item: Optional[T] = None       # first prefill job (back-compat)
    chunks: List[PrefillChunk] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Partial(Generic[T]):
    """In-flight chunked prefill.  ``pending`` is the engine-reported list of
    remaining piece sizes; empty means the engine has not reported yet (the
    item was just popped) and the item must not be re-issued."""
    item: T
    pending: List[int]
    reported: bool = False


class ContinuousBatchScheduler(Generic[T]):
    def __init__(
        self,
        config: SchedulerConfig,
        *,
        viable: Callable[[T], bool],
        admit: Optional[Callable[[T], bool]] = None,
    ):
        self.config = config
        self.viable = viable
        self.admit = admit
        self.queue: ReorderQueue[T] = ReorderQueue(
            config.reorder_window, enabled=config.reorder)
        self.prefills_running = 0
        self._partials: List[_Partial[T]] = []

    # ---- queue interface ---------------------------------------------------

    def submit(self, item: T, cached_len: int, compute_len: int) -> None:
        self.queue.push(item, cached_len, max(compute_len, 1))

    def pool_size(self) -> int:
        """Pending-prefill pool size for Algorithm 2's admission bound."""
        return len(self.queue) + self.prefills_running

    def note_prefill_start(self) -> None:
        self.prefills_running += 1

    def note_prefill_end(self) -> None:
        self.prefills_running -= 1

    # ---- chunk protocol ----------------------------------------------------

    def note_chunk_done(self, item: T, pending: Sequence[int]) -> None:
        """Engine report after executing one chunk of ``item``: the
        authoritative remaining piece sizes.  Empty = prefill complete."""
        for p in self._partials:
            if p.item is item:
                if pending:
                    p.pending = [int(n) for n in pending]
                    p.reported = True
                else:
                    self._partials.remove(p)
                    self.prefills_running -= 1
                return

    def abort_prefill(self, item: T) -> None:
        """Engine report that an in-flight chunked prefill was cancelled at a
        chunk boundary (stale speculation / finished request / resource
        pressure).  The engine has already freed the partial KV."""
        for p in self._partials:
            if p.item is item:
                self._partials.remove(p)
                self.prefills_running -= 1
                return

    # ---- the per-iteration decision ---------------------------------------

    def next_action(
        self,
        n_running: int,
        refresh: Optional[Callable[[T], tuple]] = None,
    ) -> Action[T]:
        """Decide what the engine should launch this iteration.

        n_running: current decode-batch size.
        refresh: recompute (cached_len, compute_len) per item — hit lengths
        move as the knowledge tree evolves between submit and schedule.
        """
        self.queue.prune(lambda it: not self.viable(it))
        if n_running < self.config.max_batch:
            if refresh is not None:
                self.queue.refresh(refresh)
            # admission verdicts are O(resource-state) to compute; evaluate
            # once per entry per round and reuse between the starvation
            # bump and the pop filter
            verdicts = {}

            def adm(it):
                if self.admit is None:
                    return True
                key = id(it)
                if key not in verdicts:
                    verdicts[key] = self.admit(it)
                return verdicts[key]

            blocked = lambda it: self.viable(it) and not adm(it)
            # the preemption check runs EVERY round (a stream of small
            # admissible jobs must not starve a large request forever), but
            # only while >1 request runs: evicting the sole running request
            # gains no concurrency, only recompute waste — and because the
            # engine preempts youngest-first, the oldest running request
            # always advances, which is what guarantees global progress
            # (no preemption ping-pong when the pool only fits one request)
            if (self.admit is not None and n_running > 1
                    and self.queue.max_skipped(blocked)
                    >= self.config.preempt_after_skips):
                # a request is starving on resources only: make room
                return Action(PREEMPT)

            budget = self.config.max_prefill_tokens or 0
            chunks: List[PrefillChunk] = []
            used = 0
            # 1. continue in-flight chunked prefills, oldest first — a
            # partial already holds its blocks/pins, so finishing it is
            # always the cheapest way to free resources.  Non-viable
            # partials are skipped here; the engine sweeps and aborts them
            # at its next chunk boundary.
            for p in self._partials:
                if not p.reported or not p.pending:
                    continue           # awaiting the engine's first report
                if not self.viable(p.item):
                    continue
                n = p.pending[0]
                if chunks and (budget <= 0 or used + n > budget):
                    break
                chunks.append(PrefillChunk(p.item, n, first=False))
                used += n
                if budget <= 0:
                    break              # one request per iteration
            # 2. admit new jobs while the ragged batch has budget room
            popped = False
            while not chunks or (budget > 0 and used < budget):
                cand = self.queue.peek_entry(
                    lambda it: self.viable(it) and adm(it))
                if cand is None:
                    break
                chunk_cap = self.config.prefill_chunk
                n = max(1, min(cand.compute_len, chunk_cap)
                        if chunk_cap > 0 else cand.compute_len)
                if chunks and budget > 0 and used + n > budget:
                    break              # first chunk would not fit the budget
                # entries age exactly once per scheduling ROUND, however
                # many jobs a ragged batch packs
                self.queue.remove(cand, age=not popped)
                popped = True
                self._partials.append(_Partial(cand.item, []))
                self.prefills_running += 1
                chunks.append(PrefillChunk(cand.item, n, first=True))
                used += n
                if budget <= 0:
                    break              # one request per iteration
            if not popped:
                # nothing popped, so nothing aged: bump blocked entries here
                # — exactly one increment per round either way, INCLUDING
                # continuation-only rounds of a chunked prefill (a blocked
                # request was passed over then too; freezing its skip count
                # for a whole chunked prefill would stall the starvation /
                # preemption windows)
                self.queue.bump_skipped(blocked)
            if chunks:
                return Action(PREFILL, chunks[0].item, chunks)
        if n_running > 0:
            return Action(DECODE)
        return Action(IDLE)


# --------------------------------------------------------------------------
# admission control: paged-block + tree-pin budgets
# --------------------------------------------------------------------------

def tree_pinned_gpu_bytes(tree) -> int:
    """Bytes of GPU-tier nodes pinned by in-flight requests."""
    return sum(n.bytes_ for n in tree.nodes() if n.pinned and n.in_gpu)


@dataclasses.dataclass
class PagedAdmission:
    """Budget check for one prefill job against shared serving resources.

    pool:   the device BlockPool backing both tree payloads and request
            block tables.
    tree:   the KnowledgeTree (GPU tier doubles as the doc-state budget).
    decode_reserve: tokens of decode headroom to reserve at admission
            (max_new_tokens) so a running request can never stall mid-decode.
    """
    pool: object                    # BlockPool
    tree: object                    # KnowledgeTree
    decode_reserve: int
    # cached (available_blocks, pin_headroom_bytes): the two tree walks are
    # identical for every job in a scheduling round, so the engine
    # invalidates once per kick and all queued jobs share one snapshot
    _snap: object = dataclasses.field(default=None, init=False, repr=False)

    def invalidate(self) -> None:
        self._snap = None

    def _snapshot(self):
        if self._snap is None:
            self._snap = (
                self.pool.free_blocks + self.evictable_blocks(),
                self.tree.gpu_capacity - tree_pinned_gpu_bytes(self.tree),
            )
        return self._snap

    def blocks_needed(self, context_tokens: int) -> int:
        return self.pool.blocks_for_tokens(context_tokens + self.decode_reserve)

    def evictable_blocks(self) -> int:
        """Blocks actually recoverable by evicting unpinned GPU-tier tree
        nodes. Blocks refcount-shared into a running request's block table
        do NOT count — they stay allocated after eviction, and counting
        them livelocks the engine (admission keeps green-lighting a job
        whose pagination can never succeed until a running request ends)."""
        total = 0
        for n in self.tree.nodes():
            seg = n.payload_gpu
            if n.in_gpu and not n.pinned and seg is not None \
                    and hasattr(seg, "blocks"):
                total += self.pool.exclusive(seg.blocks)
        return total

    def admissible(self, context_tokens: int, beta_tokens: int,
                   promote_tokens: int = 0) -> bool:
        """context_tokens: full sequence (docs + question) the request will
        hold in its block table; beta_tokens: to-be-computed tokens whose
        document states the prefill will pin into the tree's GPU tier;
        promote_tokens: hit-prefix tokens currently parked on host or disk —
        a pinned path needing a disk fetch / host load lands in the same GPU
        pin budget as newly computed state, so it must be admitted against
        it (otherwise a cold-tier hit over-admits exactly when the cache is
        under the most pressure)."""
        avail, headroom = self._snapshot()
        if self.blocks_needed(context_tokens) > avail:
            return False
        return ((beta_tokens + promote_tokens) * self.tree.bytes_per_token
                <= headroom)
