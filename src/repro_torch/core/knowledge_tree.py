"""The knowledge tree (paper §5.1): a prefix tree over *document ID
sequences* whose nodes hold the intermediate states (KV tensors / SSM states)
of one document conditioned on its path prefix, placed in a multi-tier
GPU/host/disk hierarchy with PGDSF replacement (Algorithm 1) run as a
generic clock cascade over the tier chain (docs/ARCHITECTURE.md §2).

Tier invariant ("parents before children in the faster tier"): if a node is
resident in tier i, its parent is resident in some tier <= i.  Eviction
therefore only ever removes tier-leaves, and the tree hierarchy mirrors the
memory hierarchy (paper Fig. 8).  Demotion cascades one tier at a time
(GPU -> host -> disk -> gone); promotion pulls the other way
(disk -> host -> GPU).  Each hop reuses the "swap-out-only-once" invariant:
a tier never recopies bytes a live slower-tier copy already holds
(``swapped_once`` for the host copy, ``spilled_once`` for the disk file).

Payloads are opaque handles managed by a ``CacheBackend`` (real JAX arrays /
mmap'd disk segments in the serving engines, byte counters in the simulator)
so the identical policy code drives both execution modes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.profiler import CostProfiler

# Tier levels, fastest first.  The cascade logic is generic over this chain;
# a zero-capacity tail tier simply never receives copies.
GPU, HOST, DISK = 0, 1, 2
TIER_NAMES = ("gpu", "host", "disk")
N_TIERS = len(TIER_NAMES)


# --------------------------------------------------------------------------
# replacement policies (PGDSF + ablation baselines, paper §7.3)
# --------------------------------------------------------------------------

class Policy:
    """Maps node stats -> eviction priority (lower evicts first)."""
    name = "base"

    def priority(self, node: "Node", clock: float) -> float:
        raise NotImplementedError


class PGDSF(Policy):
    """Priority = Clock + Frequency × AvgCost (per-non-cached-token cost from
    the bilinear profiler — Alg. 1 line 13). Prefix-aware via AvgCost."""
    name = "pgdsf"

    def priority(self, node: "Node", clock: float) -> float:
        return clock + node.frequency * node.avg_cost


class GDSF(Policy):
    """Classic GDSF with cost ∝ size (paper's ablation setting): Clock +
    Frequency × Cost/Size = Clock + Frequency × const."""
    name = "gdsf"

    def priority(self, node: "Node", clock: float) -> float:
        return clock + node.frequency * 1.0


class LRU(Policy):
    name = "lru"

    def priority(self, node: "Node", clock: float) -> float:
        return node.last_access


class LFU(Policy):
    name = "lfu"

    def priority(self, node: "Node", clock: float) -> float:
        return float(node.frequency)


POLICIES = {p.name: p for p in (PGDSF(), GDSF(), LRU(), LFU())}


# --------------------------------------------------------------------------
# backend protocol
# --------------------------------------------------------------------------

class CacheBackend:
    """Moves/frees payloads between tiers; returns the seconds each move
    costs (simulated or measured). Default: pure accounting with zero cost.

    Subclasses override the named hop methods (``swap_out``/``load`` for
    GPU<->host, ``spill``/``fetch`` for host<->disk); the generic cascade in
    ``KnowledgeTree`` dispatches through ``demote_copy``/``promote_copy``/
    ``free_tier`` so the policy code never names a tier pair."""

    def swap_out(self, node: "Node") -> float:   # GPU -> host copy
        node.payload_host = node.payload_gpu
        return 0.0

    def load(self, node: "Node") -> float:       # host -> GPU copy
        node.payload_gpu = node.payload_host
        return 0.0

    def spill(self, node: "Node") -> float:      # host -> disk write
        node.payload_disk = node.payload_host
        return 0.0

    def fetch(self, node: "Node") -> float:      # disk -> host read
        node.payload_host = node.payload_disk
        return 0.0

    def free_gpu(self, node: "Node") -> None:
        node.payload_gpu = None

    def free_host(self, node: "Node") -> None:
        node.payload_host = None

    def free_disk(self, node: "Node") -> None:
        node.payload_disk = None

    # ---- generic dispatch (indexed by tier level) ------------------------

    def demote_copy(self, node: "Node", level: int) -> float:
        """Copy ``node``'s payload from tier ``level`` to tier ``level+1``."""
        return (self.swap_out, self.spill)[level](node)

    def promote_copy(self, node: "Node", level: int) -> float:
        """Copy ``node``'s payload from tier ``level`` to tier ``level-1``."""
        return (self.load, self.fetch)[level - 1](node)

    def free_tier(self, node: "Node", level: int) -> None:
        (self.free_gpu, self.free_host, self.free_disk)[level](node)


@dataclasses.dataclass
class Node:
    doc_id: Optional[int]
    parent: Optional["Node"]
    n_tokens: int = 0
    bytes_: int = 0
    children: Dict[int, "Node"] = dataclasses.field(default_factory=dict)

    # PGDSF stats (Alg. 1)
    frequency: int = 0
    total_cost: float = 0.0
    num_computed: int = 0
    avg_cost: float = 0.0
    priority: float = 0.0
    last_access: float = 0.0

    in_gpu: bool = False
    in_host: bool = False
    in_disk: bool = False
    swapped_once: bool = False      # a live host copy exists (GPU demotes free)
    spilled_once: bool = False      # a live disk file exists (host demotes free)
    pinned: bool = False            # in active use by a running request

    payload_gpu: object = None
    payload_host: object = None
    payload_disk: object = None

    # chunk-cache mode (--reuse chunk; docs/ARCHITECTURE.md §11): the doc
    # context this node's KV was actually computed after.  ``src_prefix``
    # is the preceding doc-ID tuple at compute time; ``exact_ctx`` says
    # that context was itself exact (not patched from relocated chunks).
    # A chunk hit whose requesting context equals (src_prefix, exact) is
    # bit-identical; any other placement is RELOCATED — reusable, but only
    # with boundary-token recompute, and approximate by construction.
    # Prefix mode ignores both fields (the path IS the context).
    src_prefix: Optional[Tuple[int, ...]] = None
    exact_ctx: bool = False

    @property
    def cached(self) -> bool:
        return self.in_gpu or self.in_host or self.in_disk

    def resident(self, level: int) -> bool:
        return (self.in_gpu, self.in_host, self.in_disk)[level]

    def set_resident(self, level: int, value: bool) -> None:
        if level == GPU:
            self.in_gpu = value
        elif level == HOST:
            self.in_host = value
        else:
            self.in_disk = value

    def fastest_tier(self) -> Optional[int]:
        """Fastest tier holding a copy (None = fully uncached)."""
        for level in range(N_TIERS):
            if self.resident(level):
                return level
        return None

    def path(self) -> Tuple[int, ...]:
        ids: List[int] = []
        n: Optional[Node] = self
        while n is not None and n.doc_id is not None:
            ids.append(n.doc_id)
            n = n.parent
        return tuple(reversed(ids))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


class EvictionError(RuntimeError):
    pass


class KnowledgeTree:
    def __init__(
        self,
        gpu_capacity: int,
        host_capacity: int,
        disk_capacity: int = 0,
        *,
        policy: Policy | str = "pgdsf",
        profiler: Optional[CostProfiler] = None,
        backend: Optional[CacheBackend] = None,
        bytes_per_token: int = 1,
    ):
        if disk_capacity > 0 and host_capacity <= 0:
            raise ValueError(
                "disk tier requires a host tier (the cascade demotes and "
                "promotes strictly one tier at a time; host stages disk I/O)")
        self.root = Node(doc_id=None, parent=None, pinned=True)
        self.root.in_gpu = True     # shared system prompt lives in GPU
        self._capacity = [int(gpu_capacity), int(host_capacity),
                          int(disk_capacity)]
        self._used = [0] * N_TIERS
        self._clocks = [0.0] * N_TIERS
        self.policy = POLICIES[policy] if isinstance(policy, str) else policy
        self.profiler = profiler
        self.backend = backend or CacheBackend()
        self.bytes_per_token = bytes_per_token
        self._access_counter = itertools.count()
        # counters for benchmarks; *_seconds are the measured/simulated
        # transfer costs per tier hop (eviction cascades bill each hop)
        self.stats = {
            "hits": 0, "misses": 0,
            "gpu_evictions": 0, "host_evictions": 0, "disk_evictions": 0,
            "swap_out_bytes": 0, "load_bytes": 0, "swap_out_skipped": 0,
            "spill_bytes": 0, "fetch_bytes": 0, "spill_skipped": 0,
            "swap_out_seconds": 0.0, "load_seconds": 0.0,
            "spill_seconds": 0.0, "fetch_seconds": 0.0,
            "orphaned_bytes": 0,
            "hit_tokens_gpu": 0, "hit_tokens_host": 0, "hit_tokens_disk": 0,
        }

    # ---- tier accessor back-compat (fault_tolerance writes these) --------

    @property
    def gpu_capacity(self) -> int:
        return self._capacity[GPU]

    @property
    def host_capacity(self) -> int:
        return self._capacity[HOST]

    @property
    def disk_capacity(self) -> int:
        return self._capacity[DISK]

    @property
    def gpu_used(self) -> int:
        return self._used[GPU]

    @gpu_used.setter
    def gpu_used(self, v: int) -> None:
        self._used[GPU] = v

    @property
    def host_used(self) -> int:
        return self._used[HOST]

    @host_used.setter
    def host_used(self, v: int) -> None:
        self._used[HOST] = v

    @property
    def disk_used(self) -> int:
        return self._used[DISK]

    @disk_used.setter
    def disk_used(self, v: int) -> None:
        self._used[DISK] = v

    @property
    def gpu_clock(self) -> float:
        return self._clocks[GPU]

    @gpu_clock.setter
    def gpu_clock(self, v: float) -> None:
        self._clocks[GPU] = v

    @property
    def host_clock(self) -> float:
        return self._clocks[HOST]

    @host_clock.setter
    def host_clock(self, v: float) -> None:
        self._clocks[HOST] = v

    @property
    def disk_clock(self) -> float:
        return self._clocks[DISK]

    # ---- lookup ----------------------------------------------------------

    def match_prefix(self, doc_ids: Sequence[int]) -> List[Node]:
        """Longest cached prefix of ``doc_ids`` (paper: O(h) traversal that
        stops at the first non-cached child). Returns matched nodes in order.
        A node counts as cached in ANY tier — a disk-resident prefix is a hit
        that pays the fetch, not a miss that pays the recompute."""
        out: List[Node] = []
        cur = self.root
        for d in doc_ids:
            nxt = cur.children.get(d)
            if nxt is None or not nxt.cached:
                break
            out.append(nxt)
            cur = nxt
        return out

    def match_chunks(self, doc_ids: Sequence[int]) -> List[Optional[Node]]:
        """Chunk-cache lookup (--reuse chunk): every doc is keyed directly
        under root — the tree is flat — so each position probes
        independently and a cached doc hits at ANY position, not just on
        the longest cached prefix.  Returns one entry per position: the
        cached root child, or None for a miss.  Like ``match_prefix``, a
        copy in any tier counts as a hit."""
        out: List[Optional[Node]] = []
        for d in doc_ids:
            n = self.root.children.get(d)
            out.append(n if n is not None and n.cached else None)
        return out

    # ---- Alg. 1: UPDATE_NODE --------------------------------------------

    def update_on_access(self, node: Node, is_cached: bool,
                         alpha: int, beta: int) -> None:
        node.frequency += 1
        node.last_access = float(next(self._access_counter))
        # cost is profiled from requests that computed the node (Eq. 3); a
        # node that has only ever been hit still needs *a* cost estimate so
        # its PGDSF priority reflects its recompute value.
        if (not is_cached or node.num_computed == 0) and beta > 0:
            if self.profiler is not None:
                t = self.profiler.estimate(alpha, beta)
            else:
                t = float(beta)  # unit cost fallback
            node.total_cost += t / beta
            node.num_computed += 1
            node.avg_cost = node.total_cost / node.num_computed
        level = node.fastest_tier()
        clock = self._clocks[level] if level is not None else self._clocks[GPU]
        node.priority = self.policy.priority(node, clock)

    # ---- eviction: Alg. 1 EVICT_IN_GPU generalised to a clock cascade ----

    def _tier_leaves(self, level: int, pinned: Set[Node]) -> List[Node]:
        """Evictable nodes of tier ``level``: resident there, not resident in
        any faster tier, and with no child resident at tier <= ``level`` —
        demoting the node one tier down then keeps it at least as fast as
        every cached child (children on slower tiers are fine: the demoted
        parent stays cached).  If the demotion's copy fails outright, the
        orphaned subtree is reclaimed (see ``_orphan_subtree``) — so a node
        with a pinned cached descendant is NOT evictable: a failed copy
        would have to orphan state a running request (or in-flight fetch)
        still references."""
        # one post-order pass: does any pinned cached node live below n?
        order: List[Node] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        pinned_below: Dict[Node, bool] = {}
        for n in reversed(order):       # children before parents
            pinned_below[n] = any(
                ((c.pinned or c in pinned) and c.cached) or pinned_below[c]
                for c in n.children.values())
        out = []
        for n in order:
            if n is self.root or n in pinned or n.pinned or pinned_below[n]:
                continue
            if n.resident(level) and \
                    not any(n.resident(j) for j in range(level)) and \
                    not any(c.resident(j) for c in n.children.values()
                            for j in range(level + 1)):
                out.append(n)
        return out

    def evict_gpu(self, required: int, pinned: Optional[Set[Node]] = None) -> float:
        """Free >= required bytes of GPU tier. Returns transfer seconds spent
        on the demotion cascade. Raises EvictionError if impossible (all
        pinned)."""
        return self.evict_gpu_until(
            lambda: self.gpu_used + required <= self.gpu_capacity, pinned)

    def evict_gpu_until(self, done: Callable[[], bool],
                        pinned: Optional[Set[Node]] = None) -> float:
        """Alg. 1 EVICT_IN_GPU driven by an arbitrary stop condition —
        shared by the byte-budget loop above and external resource reclaim
        (e.g. the runtime freeing paged-pool blocks). Raises EvictionError
        if ``done()`` is still false with no evictable leaf left."""
        return self._evict_tier_until(GPU, done, pinned, strict=True)

    def evict_host(self, required: int, pinned: Optional[Set[Node]] = None) -> float:
        """Best-effort: free host bytes by spilling to disk (or dropping).
        Returns cascade transfer seconds; gives up silently when every host
        leaf is pinned (the caller skips the host copy)."""
        return self._evict_tier_until(
            HOST, lambda: self.host_used + required <= self.host_capacity,
            pinned, strict=False)

    def evict_disk(self, required: int, pinned: Optional[Set[Node]] = None) -> float:
        """Best-effort: reclaim disk files of the lowest-priority disk-only
        leaves (end of the hierarchy — the bytes are simply dropped)."""
        return self._evict_tier_until(
            DISK, lambda: self.disk_used + required <= self.disk_capacity,
            pinned, strict=False)

    def _evict_tier_until(self, level: int, done: Callable[[], bool],
                          pinned: Optional[Set[Node]] = None,
                          *, strict: bool) -> float:
        """The shared per-tier eviction loop: pop the minimum-priority tier
        leaf, advance the tier clock to its priority (the GDSF aging step,
        one clock per tier), and demote it one tier down."""
        pinned = pinned or set()
        cost = 0.0
        while not done():
            leaves = self._tier_leaves(level, pinned)
            if not leaves:
                if strict:
                    raise EvictionError(
                        f"{TIER_NAMES[level]} cache thrash: all nodes pinned")
                return cost
            victim = min(leaves, key=lambda n: n.priority)
            self._clocks[level] = max(self._clocks[level], victim.priority)
            cost += self._demote(victim, level, pinned)
            self.stats[f"{TIER_NAMES[level]}_evictions"] += 1
        return cost

    def _written_below(self, node: Node, level: int) -> bool:
        """Does a live copy already exist one tier below ``level``?"""
        return (node.swapped_once, node.spilled_once)[level]

    def _mark_written_below(self, node: Node, level: int, value: bool) -> None:
        if level == GPU:
            node.swapped_once = value
        else:
            node.spilled_once = value

    def _demote(self, node: Node, level: int,
                pinned: Optional[Set[Node]] = None) -> float:
        """Demote ``node`` one tier down from ``level`` (first time: copy;
        while a copy below is live: free, zero bytes moved).  The last tier
        demotes to nowhere — the payload is dropped and the metadata pruned.
        The caller's ``pinned`` set rides the whole cascade: a promotion's
        room-making must never evict another node of the path being
        promoted, at ANY tier."""
        cost = 0.0
        nxt = level + 1
        if nxt < N_TIERS and self._capacity[nxt] > 0:
            if not self._written_below(node, level):
                # make room below first — this is the cascade: a host
                # eviction triggered here may itself spill to disk
                cost += self._evict_tier_until(
                    nxt,
                    lambda: self._used[nxt] + node.bytes_
                    <= self._capacity[nxt],
                    pinned, strict=False)
                if self._used[nxt] + node.bytes_ <= self._capacity[nxt]:
                    t = self.backend.demote_copy(node, level)
                    cost += t
                    node.set_resident(nxt, True)
                    self._mark_written_below(node, level, True)
                    self._used[nxt] += node.bytes_
                    hop = ("swap_out", "spill")[level]
                    self.stats[f"{hop}_bytes"] += node.bytes_
                    self.stats[f"{hop}_seconds"] += t
            else:
                self.stats[("swap_out_skipped", "spill_skipped")[level]] += 1
        self.backend.free_tier(node, level)
        node.set_resident(level, False)
        if level > GPU:
            # the copy AT this level is gone: the tier above must recopy on
            # its next demotion (swap-out/spill-once tracks live copies)
            self._mark_written_below(node, level - 1, False)
        self._used[level] -= node.bytes_
        dest = node.fastest_tier()
        if dest is not None:
            # re-key priority against the clock of its new (slower) home tier
            node.priority = self.policy.priority(node, self._clocks[dest])
        else:
            # fell fully uncached (end of hierarchy, or the copy down was
            # skipped because the next tier is saturated with pinned work):
            # descendants still holding copies are unreachable now —
            # match_prefix stops at the first uncached hop — so keeping
            # their bytes is a pure leak; reclaim the whole subtree.
            self._orphan_subtree(node)
            if level > GPU:
                # GPU demotions that failed to copy keep the node's own
                # metadata — it may be recomputed and revived with stats.
                self._maybe_prune(node)
        return cost

    def _orphan_subtree(self, node: Node) -> None:
        """Free every cached copy below a node that fell fully uncached and
        prune the dead metadata.  Cannot touch pinned state: ``_tier_leaves``
        refuses to evict any node with a pinned cached descendant, so a
        request path (or an in-flight fetch's temp-pinned node) never loses
        its bytes to a failed demotion above it."""
        doomed = []
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            doomed.append(n)
        for n in doomed:
            for level in range(N_TIERS):
                if n.resident(level):
                    self.backend.free_tier(n, level)
                    n.set_resident(level, False)
                    self._used[level] -= n.bytes_
                    self.stats["orphaned_bytes"] += n.bytes_
            n.swapped_once = n.spilled_once = False
        for n in doomed:
            self._maybe_prune(n)

    def _maybe_prune(self, node: Node) -> None:
        """Drop fully-uncached leaf subtrees to bound metadata growth (keeps
        frequency stats for cached/again-reachable nodes only).  Pinned
        nodes are never pruned: a running request (or an in-flight insert /
        fetch, which temp-pins its node) still references them, and marking
        a detached object resident would leak its bytes forever."""
        while (node is not None and node is not self.root and not node.cached
               and not node.pinned
               and not node.children and node.parent is not None):
            parent = node.parent
            parent.children.pop(node.doc_id, None)
            node = parent

    # ---- insertion / promotion ------------------------------------------

    def insert(self, parent: Node, doc_id: int, n_tokens: int,
               payload=None, pinned: Optional[Set[Node]] = None) -> Tuple[Node, float]:
        """Create (or revive) child node in GPU tier. Returns (node, seconds)."""
        node = parent.children.get(doc_id)
        if node is None:
            node = Node(doc_id=doc_id, parent=parent, n_tokens=n_tokens,
                        bytes_=n_tokens * self.bytes_per_token)
            parent.children[doc_id] = node
        cost = 0.0
        if not node.in_gpu:
            # temp-pin: the room-making cascade below must not victimize or
            # prune the very node being inserted (it can be a cold-tier
            # resident — e.g. a disk hit whose promotion failed and degraded
            # to recompute — and would otherwise be the lowest-priority leaf)
            was_pinned = node.pinned
            node.pinned = True
            try:
                cost += self.evict_gpu(node.bytes_, pinned)
            finally:
                node.pinned = was_pinned
            if self.gpu_used + node.bytes_ > self.gpu_capacity:
                raise EvictionError("node larger than GPU cache")
            node.payload_gpu = payload
            node.in_gpu = True
            self.gpu_used += node.bytes_
        else:
            # already resident: keep the existing payload — with chunked /
            # batched prefill, two in-flight requests can compute the same
            # doc segment (plan→commit windows interleave); the caller frees
            # any payload the tree did not take (it owns the storage)
            if node.payload_gpu is None and payload is not None:
                node.payload_gpu = payload
        return node, cost

    def preload_disk(self, doc_id: int, n_tokens: int,
                     payload_host=None) -> Tuple[Node, float]:
        """Bulk-insert path for corpus preloading (--mode cag): create a
        root child DIRECTLY in the disk tier.  O(1) per doc — no eviction
        scan, no clock churn, no transient GPU/host residency — where
        ``insert`` + demotion cascades would run a full-tree ``_tier_leaves``
        post-order walk per node (the bulk-insert pathology: O(corpus^2) to
        preload a corpus).  Preloading never evicts: inserting beyond
        ``disk_capacity`` raises EvictionError loudly instead of thrashing
        the cascade.  ``payload_host`` is the host-layout KV payload the
        backend's ``spill`` hop writes to disk (the host copy is freed after
        the write — the node lands disk-only, promoted on demand later).
        Returns (node, spill_seconds)."""
        if self._capacity[DISK] <= 0:
            raise ValueError(
                "preload_disk requires a disk tier (disk_capacity > 0)")
        node = self.root.children.get(doc_id)
        if node is not None and node.cached:
            return node, 0.0            # already resident somewhere: no-op
        if node is None:
            node = Node(doc_id=doc_id, parent=self.root, n_tokens=n_tokens,
                        bytes_=n_tokens * self.bytes_per_token)
        if self._used[DISK] + node.bytes_ > self._capacity[DISK]:
            raise EvictionError(
                f"corpus preload overflows the disk tier: doc {doc_id} "
                f"({node.bytes_} B) does not fit "
                f"({self._used[DISK]}/{self._capacity[DISK]} B used); "
                f"raise --disk-cache-bytes to hold the whole corpus")
        node.payload_host = payload_host
        t = self.backend.spill(node)
        self.backend.free_host(node)
        node.in_disk = True
        node.spilled_once = True        # the disk file is the live copy
        self._used[DISK] += node.bytes_
        self.stats["spill_bytes"] += node.bytes_
        self.stats["spill_seconds"] += t
        # chunk-cache metadata: preloaded KV is computed at position 0 with
        # no preceding docs — exactly what commit_chunks records for a doc
        # computed first — so --reuse chunk composes with CAG preloads
        node.src_prefix = ()
        node.exact_ctx = True
        node.priority = self.policy.priority(node, self._clocks[DISK])
        self.root.children[doc_id] = node
        return node, t

    def fetch_to_host(self, node: Node, *, strict: bool = False,
                      pinned: Optional[Set[Node]] = None) -> float:
        """Stage a disk-resident node into the host tier (the first hop of a
        promotion, and the overlap hook: the runtime prefetches disk reads
        during retrieval stages so the engine-critical promote is a pure
        host->GPU copy).  Best-effort unless ``strict``; returns seconds."""
        if node.in_host or not node.in_disk:
            return 0.0
        was_pinned = node.pinned
        node.pinned = True     # room-making must not evict the fetchee
        try:
            cost = self._evict_tier_until(
                HOST,
                lambda: self.host_used + node.bytes_ <= self.host_capacity,
                pinned, strict=False)
        finally:
            node.pinned = was_pinned
        if not node.in_disk:
            # defense in depth: the room-making cascade should never be able
            # to reclaim the pinned fetchee's disk copy, but promoting a
            # freed handle would corrupt the tier state — bail instead
            if strict:
                raise EvictionError("disk copy vanished during fetch")
            return cost
        if self.host_used + node.bytes_ > self.host_capacity:
            if strict:
                raise EvictionError("disk fetch does not fit host tier")
            return cost
        t = self.backend.promote_copy(node, DISK)
        cost += t
        node.in_host = True
        node.swapped_once = True        # a live host copy exists again
        self.host_used += node.bytes_
        self.stats["fetch_bytes"] += node.bytes_
        self.stats["fetch_seconds"] += t
        # re-key against the destination tier's clock, like every other tier
        # move — a stale disk-clock priority would make the fresh fetch the
        # first host eviction victim, undoing the prefetch immediately
        node.priority = self.policy.priority(node, self._clocks[HOST])
        return cost

    def ensure_in_gpu(self, nodes: Sequence[Node]) -> float:
        """Promote a matched prefix path into GPU, cascading disk->host->GPU
        (host hits pay the PCIe transfer, disk hits additionally pay the
        mmap read — the paper's 'cache hit latency' components)."""
        cost = 0.0
        pinned = set(nodes)
        for n in nodes:
            if n.in_gpu:
                continue
            if not n.in_host:
                # disk-only: stage through host (prefetch may have done this
                # already during retrieval, making this a no-op)
                cost += self.fetch_to_host(n, strict=True, pinned=pinned)
            cost += self.evict_gpu(n.bytes_, pinned)
            if self.gpu_used + n.bytes_ > self.gpu_capacity:
                raise EvictionError("promotion does not fit GPU cache")
            t = self.backend.promote_copy(n, HOST)
            cost += t
            n.in_gpu = True
            self.gpu_used += n.bytes_
            self.stats["load_bytes"] += n.bytes_
            self.stats["load_seconds"] += t
            n.priority = self.policy.priority(n, self.gpu_clock)
        return cost

    # ---- introspection ----------------------------------------------------

    def nodes(self) -> Iterable[Node]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root:
                yield n

    def check_invariants(self) -> None:
        used = [0] * N_TIERS
        for n in self.nodes():
            for level in range(N_TIERS):
                if n.resident(level):
                    used[level] += n.bytes_
            if n.in_gpu:
                p = n.parent
                assert p is self.root or p.in_gpu, "GPU node with non-GPU parent"
            elif n.cached:
                p = n.parent
                assert p is self.root or p.cached, \
                    f"{TIER_NAMES[n.fastest_tier()]} node with free parent"
            assert n.swapped_once == n.in_host, "host-copy flag out of sync"
            assert n.spilled_once == n.in_disk, "disk-copy flag out of sync"
        for level in range(N_TIERS):
            assert used[level] == self._used[level], \
                (TIER_NAMES[level], used[level], self._used[level])
            assert self._used[level] <= self._capacity[level], TIER_NAMES[level]
