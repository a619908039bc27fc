"""Doc-affinity request routing over N engine replicas.

RAGCache's knowledge tree only pays off when a request lands on a replica
where its document prefix is already resident: chunk-level KV reuse
collapses when requests scatter across workers (Cache-Craft, arXiv
2502.15734), and the placement of retrieval state is a first-order
RAG-serving trade-off (arXiv 2412.11854).  ``ReplicaRouter`` therefore
fronts N *independent* engine replicas — each with its own
``KnowledgeTree``, ``PagedKVStore``, scheduler and three-tier cache; trees
NEVER share state across replicas, so there is no cross-replica
coherence/invalidation protocol to get wrong and a replica loss costs only
recompute — and routes each request by doc affinity:

  1. **Prefix overlap** — score every replica by the token length of the
     longest cached prefix of the request's retrieved doc-ID sequence,
     matched against both the replica's live tree (``tree.match_prefix``)
     and the router's shadow ledger of paths it already routed there
     (in-flight requests have not committed yet, but their KV is coming —
     ignoring them would scatter a burst for one document across replicas).
  2. **Affinity hash** — ties and cold paths fall back to a stable FNV-1a
     hash of the highest-order (leading) retrieved doc IDs, so the same
     document set keeps landing on the same replica before any cache state
     exists.  Fully cold decisions (no docs at all) go to the least-loaded
     replica.
  3. **Escape hatch** — affinity must not melt one replica: if routing to
     the affinity choice would push its queue depth more than
     ``max_queue_skew`` above the least-loaded replica, the request escapes
     to a least-loaded replica instead — preferring one that already holds
     part of the path — bounding routing-induced queue skew at the cost of
     at most one extra prefill of the path there.
  4. **Admission consult** — the router checks the chosen replica's
     ``PagedAdmission`` (when it exposes one) before dispatch and falls
     through to the next-least-loaded admissible replica; if *no* replica
     can admit, the decision comes back ``admitted=False`` and the caller
     queues the request — the router never admits past a replica's pin
     budget.

Routing never changes computation: a request's greedy tokens are a pure
function of (docs, question) regardless of which replica serves it or what
its cache holds, so ``--check-tokens`` stays bit-identical to the single
sequential engine at any replica count.

The router is an engine-agnostic policy object, shared the same way the
``ContinuousBatchScheduler`` is: ``launch/serve.py`` drives it over real
``ContinuousRuntime`` replicas and ``serving/simulator.py``
(``simulate_replicas``) drives the identical object over ``RAGSimulator``
replicas, so simulated and real routing cannot drift.  A replica handle is
any object; ``tree`` and ``admission`` attributes are consulted when
present (docs/ARCHITECTURE.md §8).

The port's copy of ``repro.serving.router``, statement for statement
(``tests/test_torch_imports.py`` holds the two together); the simulator
and benchmarks named above are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.config import FleetConfig, reject_legacy_kwargs

AFFINITY = "affinity"
ROUND_ROBIN = "round_robin"
LEAST_LOADED = "least_loaded"
ROUTING_POLICIES = (AFFINITY, ROUND_ROBIN, LEAST_LOADED)

# decision kinds (RouteDecision.kind) — why a request landed where it did
KIND_AFFINITY = "affinity"        # prefix overlap won
KIND_HASH = "hash"                # cold path, affinity hash of the doc IDs
KIND_ESCAPE = "escape"            # load-imbalance escape hatch fired
KIND_ADMISSION = "admission"      # preferred replica could not admit
KIND_COLD = "cold"                # no docs: least-loaded fallback
KIND_POLICY = "policy"            # non-affinity baseline policy pick


def stable_doc_hash(doc_ids: Sequence[int]) -> int:
    """FNV-1a over the doc-ID sequence: deterministic across processes and
    runs (unlike salted ``hash``), so replica placement is reproducible."""
    h = 0xcbf29ce484222325
    for d in doc_ids:
        h ^= (int(d) + 1) & 0xffffffffffffffff
        h = (h * 0x100000001b3) & 0xffffffffffffffff
    return h


@dataclasses.dataclass
class RouteDecision:
    index: int                     # chosen replica
    replica: object
    kind: str                      # KIND_* above
    admitted: bool                 # False: no replica could admit (caller
    #                                queues; router state NOT charged)
    overlap_tokens: int = 0        # prefix-overlap score of the chosen replica


@dataclasses.dataclass
class _ShadowNode:
    refs: int = 0                  # registered paths passing through here
    children: Dict[int, "_ShadowNode"] = dataclasses.field(
        default_factory=dict)


class ReplicaRouter:
    """Routes requests over independent replicas; see module docstring.

    replicas: handles of any type.  ``handle.tree`` (a ``KnowledgeTree``)
    and ``handle.admission`` (a ``PagedAdmission``) are consulted when
    present, so ``ContinuousRuntime``, ``RAGSimulator`` and bare mock
    objects all work unchanged.
    """

    def __init__(self, replicas: Sequence[object], *,
                 config=None, **legacy):
        # ``config=FleetConfig(...)`` is the SOLE constructor API: the
        # replica *count* stays the caller's job (it owns the engine list);
        # the router takes policy / max_queue_skew / max_shadow_paths from
        # the config.  The old loose kwargs raise a TypeError naming the
        # FleetConfig field that replaced them.
        reject_legacy_kwargs("ReplicaRouter", legacy, FleetConfig,
                             aliases={"policy": "routing"})
        config = config if config is not None else FleetConfig()
        policy = config.routing
        max_queue_skew = config.max_queue_skew
        max_shadow_paths = config.max_shadow_paths
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"expected one of {ROUTING_POLICIES}")
        if max_queue_skew < 1:
            raise ValueError("max_queue_skew must be >= 1")
        self.replicas = list(replicas)
        self.policy = policy
        self.max_queue_skew = max_queue_skew
        self.max_shadow_paths = max_shadow_paths
        n = len(self.replicas)
        # ACTIVE set: the front-door autoscaler (serving/frontdoor.py) may
        # restrict routing to replicas[:active]; inactive replicas keep
        # their trees/shadow state warm and still drain in-flight work, but
        # receive no new dispatches until reactivated.
        self.active = n
        self.depth = [0] * n           # in-flight (routed - completed)
        self.routed = [0] * n          # total dispatched per replica
        self.kind_counts: Dict[str, int] = {}
        self.max_skew_observed = 0
        self._rr_next = 0
        self._shadow = [_ShadowNode() for _ in range(n)]
        # FIFO of registered (replica, path) for bounded shadow size: the
        # ledger is a routing hint, not ground truth (the live tree is),
        # so aging out the oldest paths merely degrades a cold decision
        self._shadow_fifo: List[Tuple[int, Tuple[int, ...]]] = []

    # ---- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return len(self.replicas)

    def set_active(self, n: int) -> None:
        """Restrict routing to ``replicas[:n]`` (autoscaler hook).  Shrinking
        never touches a replica's state — its tree stays warm for the next
        scale-up and its in-flight requests drain normally."""
        if not 1 <= n <= len(self.replicas):
            raise ValueError(
                f"active count {n} outside [1, {len(self.replicas)}]")
        self.active = n

    def skew(self) -> int:
        d = self.depth[:self.active]
        return max(d) - min(d)

    @property
    def escaped(self) -> int:
        return self.kind_counts.get(KIND_ESCAPE, 0)

    def stats(self) -> Dict[str, object]:
        return {
            "policy": self.policy,
            "active": self.active,
            "routed": list(self.routed),
            "depth": list(self.depth),
            "kind_counts": dict(self.kind_counts),
            "escaped": self.escaped,
            "max_skew_observed": self.max_skew_observed,
            "max_queue_skew": self.max_queue_skew,
        }

    # ---- scoring ----------------------------------------------------------

    def _overlap(self, i: int, docs: Sequence[int],
                 doc_tokens: Sequence[int]) -> int:
        """Prefix-overlap score (tokens) of replica ``i`` for ``docs``: the
        longer of the live-tree match and the shadow-ledger match.  Both are
        prefix matches, so the max is the honest "KV that is or will be
        resident there" estimate."""
        live = 0
        tree = getattr(self.replicas[i], "tree", None)
        if tree is not None:
            live = sum(n.n_tokens for n in tree.match_prefix(docs))
        shadow = 0
        node = self._shadow[i]
        for d, t in zip(docs, doc_tokens):
            node = node.children.get(int(d))
            if node is None:
                break
            shadow += t
        return max(live, shadow)

    def _register(self, i: int, docs: Tuple[int, ...]) -> None:
        node = self._shadow[i]
        for d in docs:
            node = node.children.setdefault(int(d), _ShadowNode())
            node.refs += 1
        self._shadow_fifo.append((i, docs))
        if len(self._shadow_fifo) > self.max_shadow_paths:
            j, old = self._shadow_fifo.pop(0)
            self._unregister(j, old)

    def _unregister(self, i: int, docs: Tuple[int, ...]) -> None:
        node = self._shadow[i]
        for d in docs:
            child = node.children[int(d)]
            child.refs -= 1
            if child.refs == 0:
                del node.children[int(d)]
                return                 # descendants die with it (refs were
                                       # contributed by this path alone)
            node = child

    def _least_loaded(self) -> int:
        return min(range(self.active), key=lambda i: (self.depth[i], i))

    # ---- the decision -----------------------------------------------------

    def route(self, docs: Sequence[int],
              doc_tokens: Optional[Sequence[int]] = None,
              *, context_tokens: int = 0) -> RouteDecision:
        """Pick a replica for a request retrieving ``docs``.

        doc_tokens: per-doc token counts (defaults to 1 each — affinity
        still works, scores are just doc counts).  context_tokens: the
        full sequence (docs + question) the request will hold; when > 0
        and a candidate replica exposes an ``admission``, the router
        derives that replica's beta/promote tokens from ITS OWN tree
        (cached prefix shrinks beta; cold-tier hits count as promote,
        exactly like the runtime's ``_job_ctx_beta``) and consults the
        budget before dispatching.  Leave it 0 to skip budget enforcement
        (e.g. simulator replicas are unbounded).
        """
        docs = tuple(int(d) for d in docs)
        if doc_tokens is None:
            doc_tokens = (1,) * len(docs)
        chosen, kind, overlap = self._prefer(docs, doc_tokens)
        # load-imbalance escape hatch: bound max/min queue skew.  Among the
        # least-loaded replicas, prefer one that already holds (or was
        # already routed) part of this doc path — once a hot document has
        # been replicated by an earlier escape, later escapes ride the
        # existing copy instead of paying a third cold prefill.
        if self.policy == AFFINITY and docs:
            floor = min(self.depth[:self.active])
            if self.depth[chosen] + 1 - floor > self.max_queue_skew:
                cands = [i for i in range(self.active)
                         if self.depth[i] == floor]
                chosen = max(cands,
                             key=lambda i: (self._overlap(i, docs,
                                                          doc_tokens), -i))
                kind = KIND_ESCAPE
                overlap = self._overlap(chosen, docs, doc_tokens)
        # admission consult: chosen first, then the others least-loaded
        # first; a replica without an admission attribute is unbounded
        order = [chosen] + sorted(
            (i for i in range(self.active) if i != chosen),
            key=lambda i: (self.depth[i], i))
        for i in order:
            if self._admissible(i, docs, context_tokens):
                if i != chosen:
                    kind = KIND_ADMISSION
                    overlap = self._overlap(i, docs, doc_tokens)
                return self._commit(i, kind, docs, overlap)
        # nobody can admit: the caller must queue and retry — charging
        # router state now would skew load accounting for ghost requests
        return RouteDecision(index=chosen, replica=self.replicas[chosen],
                             kind=kind, admitted=False,
                             overlap_tokens=overlap)

    def _prefer(self, docs: Tuple[int, ...],
                doc_tokens: Sequence[int]) -> Tuple[int, str, int]:
        n = self.active
        if self.policy == ROUND_ROBIN:
            i = self._rr_next % n
            self._rr_next += 1
            return i, KIND_POLICY, 0
        if self.policy == LEAST_LOADED:
            return self._least_loaded(), KIND_POLICY, 0
        if not docs:
            return self._least_loaded(), KIND_COLD, 0
        home = stable_doc_hash(docs) % n
        scores = [self._overlap(i, docs, doc_tokens) for i in range(n)]
        best = max(scores)
        if best > 0:
            cands = [i for i, s in enumerate(scores) if s == best]
            chosen = home if home in cands else cands[0]
            return chosen, KIND_AFFINITY, best
        return home, KIND_HASH, 0

    def _admissible(self, i: int, docs: Tuple[int, ...], ctx: int) -> bool:
        """Consult replica ``i``'s admission for a ``ctx``-token request:
        beta (to-compute) and promote (cold-tier hit) tokens are derived
        from THIS replica's live tree, mirroring the engine's own
        ``_job_ctx_beta`` — the same docs cost different budgets on a
        replica that already caches their prefix."""
        adm = getattr(self.replicas[i], "admission", None)
        if adm is None or ctx <= 0:
            return True
        cached = promote = 0
        tree = getattr(self.replicas[i], "tree", None)
        if tree is not None:
            hit = tree.match_prefix(docs)
            cached = sum(n.n_tokens for n in hit)
            promote = sum(n.n_tokens for n in hit if not n.in_gpu)
        if hasattr(adm, "invalidate"):
            adm.invalidate()           # fresh resource snapshot per consult
        return bool(adm.admissible(ctx, max(ctx - cached, 1), promote))

    def _commit(self, i: int, kind: str, docs: Tuple[int, ...],
                overlap: int) -> RouteDecision:
        self.depth[i] += 1
        self.routed[i] += 1
        self.kind_counts[kind] = self.kind_counts.get(kind, 0) + 1
        # routing-induced skew: how far above the least-loaded replica this
        # dispatch pushed its target.  This is what the escape hatch bounds
        # (<= max_queue_skew, always).  Global max-min depth additionally
        # stays within the bound while requests only arrive; a completion
        # draining the floor under an old peak can exceed it transiently,
        # which no admission-time rule can prevent.
        self.max_skew_observed = max(
            self.max_skew_observed,
            self.depth[i] - min(self.depth[:self.active]))
        if docs:
            self._register(i, docs)
        return RouteDecision(index=i, replica=self.replicas[i], kind=kind,
                             admitted=True, overlap_tokens=overlap)

    def note_complete(self, index: int) -> None:
        """A routed request finished on ``index`` (its queue slot freed)."""
        if self.depth[index] <= 0:
            raise ValueError(
                f"replica {index} completion without a matching route")
        self.depth[index] -= 1


def partition_requests(router: ReplicaRouter, requests, docs_of,
                       doc_tokens_of=None, context_of=None,
                       window: int = 0) -> List[List[object]]:
    """Route a whole trace (arrival order) into per-replica shares.

    docs_of(request) -> doc-ID tuple; doc_tokens_of(docs) -> per-doc token
    counts (optional); context_of(request, docs, doc_tokens) -> full
    sequence token count (optional — enables the router's per-replica
    admission consult).  Shared by ``launch/serve.py`` (real runtimes) and
    ``serving/simulator.py::simulate_replicas`` so both partition a batch
    trace through the identical code path.

    A refused decision (``admitted=False``: no replica can admit right
    now) still assigns the request to the router's preferred replica —
    batch partitioning has no later retry, and the engine's OWN admission
    control queues the request once it serves — but charges no router
    depth, exactly like the decision says.

    window: how many of the most recently routed requests count as
    in-flight for the router's queue-depth/escape-hatch accounting (0 =
    all of them).  Replicas drain their queues while later requests are
    still arriving, so a Poisson trace's instantaneous backlog is a
    sliding window, not the cumulative assignment — without this, the
    escape hatch reads total assignment skew and scatters exactly the hot
    documents affinity exists to keep together.  All in-flight depth is
    drained before returning (``router.depth`` ends at zero;
    ``router.routed`` keeps the per-replica assignment).
    """
    shares: List[List[object]] = [[] for _ in router.replicas]
    in_flight: List[int] = []
    for r in requests:
        docs = tuple(docs_of(r))
        toks = None if doc_tokens_of is None else doc_tokens_of(docs)
        ctx = 0 if context_of is None else int(context_of(r, docs, toks))
        dec = router.route(docs, toks, context_tokens=ctx)
        shares[dec.index].append(r)
        if dec.admitted:
            in_flight.append(dec.index)
            if window > 0 and len(in_flight) > window:
                router.note_complete(in_flight.pop(0))
    for i in in_flight:
        router.note_complete(i)
    return shares
