"""Front-door request layer: query-level cache, SLO-aware admission, fleet
autoscaling — the subsystem AHEAD of the ``ReplicaRouter``.

RAGCache caches the *KV states* of retrieved knowledge; at millions of
users many requests should never reach an engine at all.  Real QA traffic
repeats itself (the query-cache pattern in SNIPPETS.md §1), so the front
door answers three questions per arriving request, in order:

  1. **Have we answered this exact query recently?**  ``QueryCache`` keys
     an FNV-1a hash of the question tokens; a live (non-expired) entry
     serves the cached retrieval result + finished answer with no engine
     work at all.
  2. **Have we answered a near-duplicate?**  The same cache holds each
     cached query's embedding vector; a cosine probe at/above
     ``sim_threshold`` serves the cached entry too.  Similarity hits are
     *approximate by contract*: the cached answer belongs to a semantically
     close query, and the TTL bounds how stale either hit can be.
  3. **Can the fleet afford this miss right now?**  ``SloAdmission``
     predicts TTFT from the current backlog and an EWMA of observed
     service times; when the prediction exceeds the request's per-tenant
     target it first *degrades* (lowers the request's ``top_k`` toward the
     tenant's floor — less context, faster prefill), and *sheds* only when
     even the floor cannot meet a multiple of the target.

``FleetAutoscaler`` closes the loop: it grows/shrinks the ACTIVE replica
count within ``[min_replicas, max_replicas]`` against backlog/TTFT
signals (hysteresis + cooldown so bursts don't thrash), and every
scale-up warms the joining replica by seeding its knowledge tree from its
disk tier (``warm_from_disk``: disk-resident nodes staged into host
memory, so the first requests pay a host->GPU copy instead of a
recompute).  Scale-down never destroys a replica — it stops routing to it,
and the replica's tree (including its disk tier) stays warm for the next
scale-up.

Policy cannot drift between simulation and the real runtime: the SAME
``FrontDoor``/``SloAdmission``/``FleetAutoscaler`` objects are driven by
``serving/simulator.py::simulate_frontdoor`` over ``RAGSimulator``
replicas and by ``launch/serve.py --frontdoor`` over real
``ContinuousRuntime`` replicas, through the shared
``frontdoor_partition`` trace walk below (the shared-policy pattern of
the scheduler and the router; asserted by tests/test_frontdoor.py).

Front-door hits never change engine computation — they bypass it — and
misses are forwarded with an explicit per-request ``top_k``, so
``--check-tokens`` stays bit-identical for every miss at any replica
count (degraded misses included: both engines honor ``Request.top_k``).

The port's copy of ``repro.serving.frontdoor``, statement for statement
(``tests/test_torch_imports.py`` holds the two together); the simulator
and benchmarks named above are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.retrieval.corpus import Request

# lookup kinds
HIT_EXACT = "hit_exact"
HIT_SIMILAR = "hit_similar"
MISS = "miss"
# admission actions
ADMIT = "admit"
DEGRADE = "degrade"
SHED = "shed"


def query_key(question_tokens) -> int:
    """FNV-1a over the question-token bytes: deterministic across processes
    (unlike salted ``hash``), so cache behavior is reproducible."""
    h = 0xcbf29ce484222325
    for t in np.asarray(question_tokens).ravel():
        h ^= (int(t) + 1) & 0xffffffffffffffff
        h = (h * 0x100000001b3) & 0xffffffffffffffff
    return h


@dataclasses.dataclass
class CacheEntry:
    key: int
    vec: np.ndarray                # unit-normalized query embedding
    docs: Tuple[int, ...]          # cached retrieval result
    answer: List[int]              # finished answer tokens
    source_req_id: int             # request that produced the entry
    created: float                 # insertion time (TTL anchors here —
    #                                a hit never refreshes freshness, so
    #                                staleness is bounded by exactly ttl)
    top_k: int                     # effective retrieval depth the answer
    #                                was generated with (>= 1, always
    #                                recorded explicitly); a lookup
    #                                demanding more depth must NOT be
    #                                served this entry


class QueryCache:
    """Exact + embedding-similarity request cache with TTL expiry and an
    LRU capacity bound.

    Exact hits key the FNV-1a hash of the question tokens; similarity hits
    cosine-probe the cached (unit-normalized) query vectors and serve the
    best entry at/above ``sim_threshold``.  ``sim_threshold >= 1.0``
    disables the similarity probe (exact-only).  Entries expire ``ttl``
    seconds after INSERTION regardless of use, and the LRU bound evicts
    the least-recently-HIT entry first — recency of use keeps an entry
    resident, but never extends its freshness.
    """

    def __init__(self, *, capacity: int = 1024, ttl: float = 60.0,
                 sim_threshold: float = 0.98):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not 0.0 < ttl:
            raise ValueError("ttl must be positive")
        self.capacity = capacity
        self.ttl = ttl
        self.sim_threshold = sim_threshold
        self._entries: "OrderedDict[int, CacheEntry]" = OrderedDict()
        self._mat: Optional[np.ndarray] = None   # stacked vecs, rebuilt lazily
        self._mat_keys: List[int] = []
        self.hits_exact = 0
        self.hits_similar = 0
        self.misses = 0
        self.expired = 0
        self.evicted = 0
        self.depth_filtered = 0    # live entries skipped: cached top_k too
        #                            shallow for the lookup's required depth

    def __len__(self) -> int:
        return len(self._entries)

    def _invalidate_mat(self) -> None:
        self._mat = None
        self._mat_keys = []

    def _expire(self, now: float) -> None:
        stale = [k for k, e in self._entries.items()
                 if e.created + self.ttl <= now]
        for k in stale:
            del self._entries[k]
            self.expired += 1
        if stale:
            self._invalidate_mat()

    def lookup(self, query_vec: np.ndarray, question_tokens,
               now: float, *, min_top_k: int = 0
               ) -> Tuple[str, Optional[CacheEntry]]:
        """(kind, entry): kind is HIT_EXACT / HIT_SIMILAR / MISS.  Expired
        entries are reclaimed first, so they can never be served.

        ``min_top_k``: required retrieval depth — an entry whose recorded
        ``top_k`` is below it is invisible to BOTH probes (a degraded
        tenant's answer must never serve a full-depth request).  Every
        entry records its effective depth explicitly (>= 1), so there is
        no unknown/legacy case to special-case here.
        """
        self._expire(now)
        key = query_key(question_tokens)
        entry = self._entries.get(key)
        if entry is not None:
            if entry.top_k >= min_top_k:
                self._entries.move_to_end(key)
                self.hits_exact += 1
                return HIT_EXACT, entry
            self.depth_filtered += 1   # too shallow: fall through to the
            #                            similarity probe / miss
        if self.sim_threshold < 1.0 and self._entries:
            if self._mat is None:
                self._mat_keys = list(self._entries)
                self._mat = np.stack(
                    [self._entries[k].vec for k in self._mat_keys])
            q = np.asarray(query_vec, np.float32)
            q = q / max(float(np.linalg.norm(q)), 1e-12)
            sims = self._mat @ q
            if min_top_k > 0:
                ok = np.asarray(
                    [self._entries[k].top_k >= min_top_k
                     for k in self._mat_keys])
                sims = np.where(ok, sims, -np.inf)
            best = int(np.argmax(sims))
            if float(sims[best]) >= self.sim_threshold:
                k = self._mat_keys[best]
                self._entries.move_to_end(k)
                self.hits_similar += 1
                return HIT_SIMILAR, self._entries[k]
        self.misses += 1
        return MISS, None

    def insert(self, query_vec: np.ndarray, question_tokens,
               docs: Sequence[int], answer: Sequence[int],
               source_req_id: int, now: float, *,
               top_k: int) -> CacheEntry:
        if top_k < 1:
            raise ValueError(
                "CacheEntry.top_k records the EFFECTIVE retrieval depth and "
                "must be >= 1 (the 0 = unknown/legacy sentinel is retired)")
        self._expire(now)
        key = query_key(question_tokens)
        vec = np.asarray(query_vec, np.float32)
        vec = vec / max(float(np.linalg.norm(vec)), 1e-12)
        entry = CacheEntry(key=key, vec=vec, docs=tuple(int(d) for d in docs),
                           answer=[int(t) for t in answer],
                           source_req_id=source_req_id, created=now,
                           top_k=int(top_k))
        self._entries[key] = entry      # re-insert refreshes freshness
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evicted += 1
        self._invalidate_mat()
        return entry

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._entries),
            "capacity": self.capacity,
            "hits_exact": self.hits_exact,
            "hits_similar": self.hits_similar,
            "misses": self.misses,
            "expired": self.expired,
            "evicted": self.evicted,
            "depth_filtered": self.depth_filtered,
        }


@dataclasses.dataclass
class TenantSLO:
    ttft_target: float             # seconds
    min_top_k: int = 1             # degrade floor


@dataclasses.dataclass
class AdmissionDecision:
    action: str                    # ADMIT / DEGRADE / SHED
    top_k: int                     # effective retrieval depth for the engine
    predicted_ttft: float


class SloAdmission:
    """Per-tenant SLO-aware admission: shed or degrade when predicted TTFT
    exceeds the tenant's target.

    Predicted TTFT = (backlog / active_replicas + 1) * service-time EWMA:
    the request waits behind its share of the fleet backlog (the QUEUEING
    term), then pays one service time itself (the SERVICE term).
    Degrading lowers the request's ``top_k`` — prefill cost is roughly
    linear in retrieved context, so serving k' of k docs scales the
    predicted SERVICE term by k'/k; the queueing term is other requests'
    work and does not shrink when this one retrieves fewer docs.  If even
    the tenant's ``min_top_k`` floor predicts more than ``shed_factor``
    x target, the request is shed (a deliberate hysteresis band: between
    1x and ``shed_factor`` x target the degraded floor is still admitted,
    so a cold or noisy service estimate sheds nothing).  A deep backlog is
    therefore shed, never "degraded away": no value of k' can scale the
    queueing term below the target."""

    def __init__(self, slos: Dict[str, TenantSLO], *,
                 default: Optional[TenantSLO] = None, top_k: int = 2,
                 shed_factor: float = 2.0, ewma_alpha: float = 0.2,
                 init_service: float = 0.05):
        if top_k < 1:
            raise ValueError("top_k must be >= 1")
        self.slos = dict(slos)
        self.default = default or TenantSLO(ttft_target=0.5)
        self.top_k = top_k
        self.shed_factor = shed_factor
        self.ewma_alpha = ewma_alpha
        self.service_est = init_service   # EWMA of observed per-request TTFT
        self.decisions: Dict[str, int] = {ADMIT: 0, DEGRADE: 0, SHED: 0}

    def slo_of(self, tenant: str) -> TenantSLO:
        return self.slos.get(tenant, self.default)

    def predicted_ttft(self, backlog: int, active: int) -> float:
        return (backlog / max(active, 1) + 1.0) * self.service_est

    def decide(self, tenant: str, backlog: int,
               active: int) -> AdmissionDecision:
        slo = self.slo_of(tenant)
        # queueing: waiting behind other requests' (full-depth) work —
        # invariant under THIS request's top_k.  service: this request's
        # own prefill, the only part degrading can shrink.
        queue = (backlog / max(active, 1)) * self.service_est
        service = self.service_est
        pred = queue + service
        k = self.top_k
        if pred <= slo.ttft_target:
            self.decisions[ADMIT] += 1
            return AdmissionDecision(ADMIT, k, pred)
        floor = max(1, min(slo.min_top_k, self.top_k))
        while k > floor and \
                queue + service * k / self.top_k > slo.ttft_target:
            k -= 1
        if queue + service * k / self.top_k \
                > self.shed_factor * slo.ttft_target:
            self.decisions[SHED] += 1
            return AdmissionDecision(SHED, 0, pred)
        action = DEGRADE if k < self.top_k else ADMIT
        self.decisions[action] += 1
        return AdmissionDecision(action, k, pred)

    def observe_ttft(self, ttft: float) -> None:
        if ttft >= 0:
            a = self.ewma_alpha
            self.service_est = (1 - a) * self.service_est + a * ttft


@dataclasses.dataclass
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 1
    scale_up_backlog: float = 8.0   # backlog PER ACTIVE replica above which
    #                                 the fleet grows
    scale_down_backlog: float = 2.0  # per-replica backlog below which it
    #                                  shrinks (hysteresis band between)
    target_ttft: float = 0.0        # optional TTFT trigger (0 = backlog-only):
    #                                 grow when the service EWMA-based
    #                                 prediction exceeds this
    cooldown: float = 2.0           # seconds between scale events

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.scale_down_backlog > self.scale_up_backlog:
            raise ValueError("scale_down_backlog must be <= scale_up_backlog")


@dataclasses.dataclass
class ScaleEvent:
    t: float
    active: int                    # fleet size AFTER the event
    reason: str


class FleetAutoscaler:
    """Grows/shrinks the ACTIVE replica count within configured bounds
    against queue-depth / predicted-TTFT signals.  Pure policy: the caller
    (``frontdoor_partition``) applies the returned count to the router's
    active set and warms joining replicas."""

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self.active = cfg.min_replicas
        self.events: List[ScaleEvent] = []
        self.min_seen = self.active
        self.max_seen = self.active
        self._last_event = -1e18

    def observe(self, now: float, backlog: int,
                predicted_ttft: float = 0.0) -> int:
        """Feed one load sample; returns the (possibly new) active count."""
        cfg = self.cfg
        if now - self._last_event < cfg.cooldown:
            return self.active
        per = backlog / max(self.active, 1)
        if self.active < cfg.max_replicas and (
                per > cfg.scale_up_backlog
                or (cfg.target_ttft > 0.0
                    and predicted_ttft > cfg.target_ttft)):
            self.active += 1
            why = (f"backlog/replica {per:.1f} > {cfg.scale_up_backlog}"
                   if per > cfg.scale_up_backlog else
                   f"pred TTFT {predicted_ttft * 1e3:.0f}ms > "
                   f"{cfg.target_ttft * 1e3:.0f}ms")
            self.events.append(ScaleEvent(now, self.active, f"up: {why}"))
            self._last_event = now
        elif self.active > cfg.min_replicas and per < cfg.scale_down_backlog \
                and (cfg.target_ttft <= 0.0
                     or predicted_ttft <= cfg.target_ttft):
            self.active -= 1
            self.events.append(ScaleEvent(
                now, self.active,
                f"down: backlog/replica {per:.1f} < "
                f"{cfg.scale_down_backlog}"))
            self._last_event = now
        self.min_seen = min(self.min_seen, self.active)
        self.max_seen = max(self.max_seen, self.active)
        return self.active

    def stats(self) -> Dict[str, object]:
        return {
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "active": self.active,
            "min_seen": self.min_seen,
            "max_seen": self.max_seen,
            "events": [(e.t, e.active, e.reason) for e in self.events],
        }


def warm_from_disk(replica, max_bytes: int = 0) -> int:
    """Seed a joining replica's knowledge tree from its DISK tier: stage
    disk-only nodes into host memory (top-down, parents first — the tier
    invariant) so the replica's first requests pay a host->GPU copy, not a
    full recompute.  Returns bytes staged.  A replica with no tree or no
    disk-resident state warms for free (0 bytes) — scale-down keeps trees
    intact precisely so this pays on the next scale-up."""
    tree = getattr(replica, "tree", None)
    if tree is None:
        return 0
    before = tree.stats.get("fetch_bytes", 0)
    budget = max_bytes if max_bytes > 0 else None
    stack = [tree.root]
    while stack:
        node = stack.pop()
        if node is not tree.root and node.in_disk and not node.in_host \
                and not node.in_gpu:
            tree.fetch_to_host(node)
            if budget is not None \
                    and tree.stats.get("fetch_bytes", 0) - before >= budget:
                break
        stack.extend(node.children.values())
    return tree.stats.get("fetch_bytes", 0) - before


@dataclasses.dataclass
class FrontDoorDecision:
    kind: str                      # HIT_EXACT / HIT_SIMILAR / SHED / MISS
    top_k: int = 0                 # effective retrieval depth (misses only)
    degraded: bool = False
    entry: Optional[CacheEntry] = None
    predicted_ttft: float = 0.0


class FrontDoor:
    """The composed policy object driven identically by the simulator and
    the real runtime (module docstring).  Per-request flow:

        exact hit -> similarity hit -> SLO admission (shed/degrade) ->
        autoscaler observe -> forward to the replica router
    """

    # analytic cost of a front-door hit: hash + cosine probe + queue pop.
    # Charged as the hit's TTFT so "mean TTFT with the front door on"
    # never pretends cache lookups are free.
    LOOKUP_SECONDS = 2e-4

    def __init__(self, cache: QueryCache, admission: SloAdmission,
                 autoscaler: Optional[FleetAutoscaler] = None, **legacy):
        if legacy:
            # assembled-objects API: knobs live in the components, built
            # from FrontDoorConfig via make_frontdoor() — loose kwargs here
            # were never a config channel and fail loudly naming it
            raise TypeError(
                f"FrontDoor() takes (cache, admission, autoscaler) only; "
                f"unexpected kwarg(s) {sorted(legacy)} — build the stack "
                f"from FrontDoorConfig via make_frontdoor() "
                f"(serving/config.py; docs/ARCHITECTURE.md §10)")
        self.cache = cache
        self.admission = admission
        self.autoscaler = autoscaler
        self.backlog = 0               # admitted misses in flight
        self.shed_by_tenant: Dict[str, int] = {}
        self.degraded = 0
        # per-tenant SLO attainment: tenant -> [completed, attained]
        self._slo_counts: Dict[str, List[int]] = {}

    # ---- per-request decision -------------------------------------------

    def active_replicas(self) -> int:
        return self.autoscaler.active if self.autoscaler is not None else 1

    def required_top_k(self, r: Request) -> int:
        """Depth this request's answer must have been generated with: its
        own explicit ``top_k`` when set, else the fleet's full default —
        a previously-degraded tenant's cached answer must not be served
        to a request admitted at full depth."""
        return int(r.top_k) if r.top_k > 0 else self.admission.top_k

    def handle(self, r: Request, now: float) -> FrontDoorDecision:
        kind, entry = self.cache.lookup(r.query_vec, r.question_tokens, now,
                                        min_top_k=self.required_top_k(r))
        if entry is not None:
            self._note_slo(r.tenant, self.LOOKUP_SECONDS)
            return FrontDoorDecision(kind=kind, entry=entry)
        dec = self.admission.decide(r.tenant, self.backlog,
                                    self.active_replicas())
        if dec.action == SHED:
            self.shed_by_tenant[r.tenant] = \
                self.shed_by_tenant.get(r.tenant, 0) + 1
            return FrontDoorDecision(kind=SHED,
                                     predicted_ttft=dec.predicted_ttft)
        if dec.action == DEGRADE:
            self.degraded += 1
        self.backlog += 1
        if self.autoscaler is not None:
            self.autoscaler.observe(now, self.backlog, dec.predicted_ttft)
        return FrontDoorDecision(kind=MISS, top_k=dec.top_k,
                                 degraded=dec.action == DEGRADE,
                                 predicted_ttft=dec.predicted_ttft)

    # ---- completion feedback --------------------------------------------

    def note_complete(self, r: Request, docs: Sequence[int],
                      answer: Sequence[int], ttft: float,
                      now: float) -> None:
        """An admitted miss finished on some replica: populate the query
        cache with its retrieval result + answer, update the service-time
        estimate and the tenant's SLO attainment, release backlog."""
        self.backlog = max(0, self.backlog - 1)
        self.admission.observe_ttft(ttft)
        self._note_slo(r.tenant, ttft)
        self.cache.insert(r.query_vec, r.question_tokens, docs, answer,
                          r.req_id, now, top_k=self.required_top_k(r))
        if self.autoscaler is not None:
            self.autoscaler.observe(
                now, self.backlog,
                self.admission.predicted_ttft(self.backlog,
                                              self.active_replicas()))

    def _note_slo(self, tenant: str, ttft: float) -> None:
        c = self._slo_counts.setdefault(tenant, [0, 0])
        c[0] += 1
        if ttft <= self.admission.slo_of(tenant).ttft_target:
            c[1] += 1

    # ---- reporting -------------------------------------------------------

    def slo_attainment(self) -> Dict[str, Tuple[int, int, float]]:
        """tenant -> (completed, attained, fraction)."""
        return {t: (c[0], c[1], c[1] / c[0] if c[0] else 0.0)
                for t, c in sorted(self._slo_counts.items())}

    def stats(self) -> Dict[str, object]:
        cs = self.cache.stats()
        handled = cs["hits_exact"] + cs["hits_similar"] + cs["misses"]
        out: Dict[str, object] = {
            "cache": cs,
            "hit_rate": ((cs["hits_exact"] + cs["hits_similar"])
                         / max(handled, 1)),
            "shed": dict(self.shed_by_tenant),
            "shed_total": sum(self.shed_by_tenant.values()),
            "degraded": self.degraded,
            "admission": dict(self.admission.decisions),
            "slo_attainment": {
                t: {"completed": n, "attained": a, "fraction": f}
                for t, (n, a, f) in self.slo_attainment().items()},
            "slo_targets_ms": {t: s.ttft_target * 1e3
                               for t, s in sorted(
                                   self.admission.slos.items())},
        }
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.stats()
        return out


# --------------------------------------------------------------------------
# the shared trace walk: simulator and real runtimes partition through HERE
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FrontDoorPartition:
    """Outcome of routing one trace through the front door.

    shares[i] holds the (possibly ``top_k``-rewritten) miss requests
    assigned to replica i; hits/shed never reach a replica.  ``warmed``
    maps replica index -> bytes staged from its disk tier at scale-up."""
    shares: List[List[Request]]
    hits: List[Tuple[Request, FrontDoorDecision]]
    shed: List[Request]
    misses: List[Request]          # rewritten requests, arrival order
    warmed: Dict[int, int]


def frontdoor_partition(fd: FrontDoor, router, requests: Sequence[Request],
                        *, docs_of: Callable[[Request], Sequence[int]],
                        doc_tokens_of=None, context_of=None,
                        window: int = 0,
                        warm_replica: Callable = warm_from_disk,
                        ) -> FrontDoorPartition:
    """Walk a trace (arrival order) through the front door and the replica
    router.  Mirrors ``router.partition_requests`` — and is shared the
    same way: ``launch/serve.py --frontdoor`` (real runtimes) and
    ``serving/simulator.py::simulate_frontdoor`` (RAGSimulator replicas)
    both call THIS function with the SAME policy objects, so front-door
    behavior cannot drift between simulation and reality.

    The sliding ``window`` models per-replica backlog draining while the
    trace arrives (identical to partition_requests): a request leaving the
    window completes — the front door learns its retrieval result +
    answer-to-be (cache insert keyed by the ORIGINAL request; the answer
    tokens are attached by the caller after serving via ``hits``'
    ``entry.source_req_id``), the admission layer gets a service-time
    sample, and the autoscaler sees the drained backlog.  Completion-time
    TTFT feedback uses the admission layer's own prediction at dispatch —
    the caller can re-observe real TTFTs afterwards, but the PARTITION
    must be a function of the trace alone so both engines replay it
    identically.

    Autoscale events fire inside ``fd.handle``; this walk applies them:
    the router's active set follows ``fd.autoscaler.active``, and every
    replica joining the active set is warmed from its disk tier.
    """
    shares: List[List[Request]] = [[] for _ in router.replicas]
    hits: List[Tuple[Request, FrontDoorDecision]] = []
    shed: List[Request] = []
    misses: List[Request] = []
    warmed: Dict[int, int] = {}
    in_flight: List[Tuple[int, Request, Sequence[int], float]] = []
    active = router.active
    if fd.autoscaler is not None:
        # the fleet starts at the autoscaler's current count (min_replicas
        # on a fresh scaler), growing only as load demands
        active = min(fd.autoscaler.active, len(router.replicas))
        router.set_active(active)

    def _complete(idx: int, req: Request, docs: Sequence[int],
                  pred: float, now: float) -> None:
        router.note_complete(idx)
        fd.note_complete(req, docs, [], pred, now)

    for r in sorted(requests, key=lambda q: q.arrival):
        now = r.arrival
        dec = fd.handle(r, now)
        if dec.kind in (HIT_EXACT, HIT_SIMILAR):
            hits.append((r, dec))
            continue
        if dec.kind == SHED:
            shed.append(r)
            continue
        # autoscaler may have grown/shrunk the fleet on this arrival
        if fd.autoscaler is not None and fd.autoscaler.active != active:
            grew = range(active, fd.autoscaler.active)
            active = fd.autoscaler.active
            router.set_active(active)
            for i in grew:
                warmed[i] = warmed.get(i, 0) + int(
                    warm_replica(router.replicas[i]) or 0)
        req = r if dec.top_k == fd.admission.top_k \
            else dataclasses.replace(r, top_k=dec.top_k)
        docs = tuple(docs_of(req))
        toks = None if doc_tokens_of is None else doc_tokens_of(docs)
        ctx = 0 if context_of is None else int(context_of(req, docs, toks))
        rd = router.route(docs, toks, context_tokens=ctx)
        shares[rd.index].append(req)
        misses.append(req)
        if rd.admitted:
            in_flight.append((rd.index, req, docs, dec.predicted_ttft))
            if window > 0 and len(in_flight) > window:
                idx, q, d, pred = in_flight.pop(0)
                _complete(idx, q, d, pred, now)
        else:
            # no replica could admit: the engine's own admission queues it;
            # front-door backlog still drains when the window slides
            fd.backlog = max(0, fd.backlog - 1)
    for idx, q, d, pred in in_flight:
        _complete(idx, q, d, pred, q.arrival)
    return FrontDoorPartition(shares=shares, hits=hits, shed=shed,
                              misses=misses, warmed=warmed)


def attach_answers(part: FrontDoorPartition,
                   answers: Dict[int, Sequence[int]]) -> None:
    """After serving, fill each cache entry's answer tokens from the source
    request's served tokens (req_id -> tokens).  Hit decisions share the
    entry object, so hits see the answer too."""
    for _, dec in part.hits:
        if dec.entry is not None and not dec.entry.answer:
            src = answers.get(dec.entry.source_req_id)
            if src is not None:
                dec.entry.answer = [int(t) for t in src]


def make_frontdoor(*, capacity: int = 512, ttl: float = 60.0,
                   sim_threshold: float = 0.98,
                   slos: Optional[Dict[str, TenantSLO]] = None,
                   default_slo_ttft: float = 0.5, top_k: int = 2,
                   min_replicas: int = 1, max_replicas: int = 1,
                   autoscale: bool = False,
                   scale_up_backlog: float = 8.0,
                   scale_down_backlog: float = 2.0,
                   cooldown: float = 2.0,
                   init_service: float = 0.05) -> FrontDoor:
    """One-call constructor shared by serve.py, simulate_frontdoor and the
    benchmarks, so every caller assembles the identical policy stack."""
    cache = QueryCache(capacity=capacity, ttl=ttl,
                       sim_threshold=sim_threshold)
    admission = SloAdmission(
        slos or {}, default=TenantSLO(ttft_target=default_slo_ttft),
        top_k=top_k, init_service=init_service)
    scaler = None
    if autoscale:
        scaler = FleetAutoscaler(AutoscaleConfig(
            min_replicas=min_replicas, max_replicas=max_replicas,
            scale_up_backlog=scale_up_backlog,
            scale_down_backlog=scale_down_backlog, cooldown=cooldown))
    return FrontDoor(cache, admission, scaler)
