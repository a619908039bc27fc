"""RAG controller (paper Fig. 7): the orchestration logic shared verbatim by
the real JAX serving engine and the discrete-event simulator.

Given a request's retrieved document sequence it plans the prefix hit
(promotions + alpha/beta split), and after prefill it commits the newly
computed document states into the knowledge tree and refreshes PGDSF stats.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.knowledge_tree import EvictionError, KnowledgeTree, Node


@dataclasses.dataclass
class ChunkItem:
    """Per-position placement decision in chunk-cache mode (--reuse chunk).

    kind:
      * ``miss``  — no cached KV: compute all ``n_tokens`` fresh;
      * ``exact`` — cached KV was computed after this exact doc prefix
        (``node.src_prefix == ctx`` with ``exact_ctx``): reuse all of it,
        bit-identical;
      * ``reloc`` — cached KV exists but for a different context/position:
        reuse the tail, recompute the first ``recompute`` boundary tokens
        against the true preceding context (approximate by construction —
        the reused tail keeps its original RoPE rotations)."""
    kind: str                        # "miss" | "exact" | "reloc"
    doc_id: int
    n_tokens: int                    # full doc token count
    node: Optional[Node]             # cached node (exact/reloc), else None
    recompute: int = 0               # boundary tokens recomputed (reloc)

    @property
    def reused(self) -> int:
        return 0 if self.kind == "miss" else self.n_tokens - self.recompute


@dataclasses.dataclass
class RequestPlan:
    doc_ids: Tuple[int, ...]
    doc_tokens: Tuple[int, ...]      # token count per retrieved doc
    question_tokens: int
    hit_nodes: List[Node]            # longest cached prefix (in order)
    alpha: int                       # cached tokens (prefix docs)
    beta: int                        # tokens to compute (rest docs + question)
    promote_bytes: int               # host/disk->GPU bytes for the hit
    hit_docs: int                    # for the paper's per-doc hit-rate metric
    # per-tier hit attribution at plan time: alpha tokens split by the tier
    # each hit node was resident in (gpu, host, disk)
    hit_tier_tokens: Tuple[int, int, int] = (0, 0, 0)
    # chunk-cache mode only: one ChunkItem per doc position (None = prefix
    # mode).  hit_nodes then holds the exact/reloc nodes in position order.
    chunks: Optional[List[ChunkItem]] = None
    # was the materialized context exact end-to-end at plan time?  (False
    # as soon as one chunk is relocated — the request's outputs are then
    # approximate and only tolerance verification applies.)
    exact: bool = True

    @property
    def full_len(self) -> int:
        return self.alpha + self.beta


def effective_recompute(recompute_tokens: int, n_tokens: int,
                        block_size: int) -> int:
    """Boundary-recompute width for one relocated chunk, page-aligned UP:
    the reused tail must start at a page boundary (run tables address whole
    pages from slot 0 — kernels/paged_attention.py contract), so the
    recomputed head rounds up to the block size.  Clamps to the chunk
    length: at or past it the chunk degenerates to an exact full
    recompute (the tolerance-mode hypothesis property)."""
    if recompute_tokens >= n_tokens:
        return n_tokens
    bs = max(1, int(block_size))
    r = ((max(0, int(recompute_tokens)) + bs - 1) // bs) * bs
    return min(r, n_tokens)


class RAGController:
    def __init__(self, tree: KnowledgeTree):
        self.tree = tree
        self.total_docs = 0
        self.total_hit_docs = 0

    # ---- planning ---------------------------------------------------------

    def plan(self, doc_ids: Sequence[int], doc_tokens: Sequence[int],
             question_tokens: int) -> RequestPlan:
        hit = self.tree.match_prefix(doc_ids)
        alpha = sum(n.n_tokens for n in hit)
        beta = sum(doc_tokens[len(hit):]) + question_tokens
        promote = sum(n.bytes_ for n in hit if not n.in_gpu)
        tier_tokens = [0, 0, 0]
        for n in hit:
            tier_tokens[n.fastest_tier()] += n.n_tokens
        for name, toks in zip(("gpu", "host", "disk"), tier_tokens):
            self.tree.stats[f"hit_tokens_{name}"] += toks
        self.total_docs += len(doc_ids)
        self.total_hit_docs += len(hit)
        self.tree.stats["hits" if hit else "misses"] += 1
        return RequestPlan(
            doc_ids=tuple(doc_ids),
            doc_tokens=tuple(doc_tokens),
            question_tokens=question_tokens,
            hit_nodes=list(hit),
            alpha=alpha,
            beta=beta,
            promote_bytes=promote,
            hit_docs=len(hit),
            hit_tier_tokens=tuple(tier_tokens),
        )

    def plan_chunks(self, doc_ids: Sequence[int], doc_tokens: Sequence[int],
                    question_tokens: int, *, recompute_tokens: int,
                    block_size: int = 1) -> RequestPlan:
        """Chunk-cache planning (--reuse chunk): probe every doc position
        independently via ``match_chunks`` and classify each as
        miss / exact / reloc (see ``ChunkItem``).  alpha counts the REUSED
        tokens (exact chunks whole, relocated chunks minus their boundary
        recompute); beta is everything computed (misses + boundaries +
        question), so alpha + beta == full_len exactly as in prefix mode
        and every downstream accounting path keeps working."""
        tree = self.tree
        match = tree.match_chunks(doc_ids)
        chunks: List[ChunkItem] = []
        hit_nodes: List[Node] = []
        tier_tokens = [0, 0, 0]
        exact_so_far = True
        for i, (d, node) in enumerate(zip(doc_ids, match)):
            n_tok = int(doc_tokens[i])
            if node is not None and node.exact_ctx \
                    and node.src_prefix == tuple(doc_ids[:i]):
                # the cached KV was computed after exactly this doc prefix
                # with an exact context: reusing it IS the full-recompute
                # value — zero boundary recompute, exactness preserved
                item = ChunkItem("exact", int(d), n_tok, node)
            elif node is not None:
                r = effective_recompute(recompute_tokens, n_tok, block_size)
                if r >= n_tok:
                    # boundary covers the whole chunk: plain full recompute
                    item = ChunkItem("miss", int(d), n_tok, None)
                else:
                    item = ChunkItem("reloc", int(d), n_tok, node,
                                     recompute=r)
                    exact_so_far = False
            else:
                item = ChunkItem("miss", int(d), n_tok, None)
            chunks.append(item)
            if item.node is not None:
                hit_nodes.append(item.node)
                tier_tokens[item.node.fastest_tier()] += item.reused
        alpha = sum(it.reused for it in chunks)
        beta = sum(it.n_tokens if it.kind == "miss" else it.recompute
                   for it in chunks) + question_tokens
        promote = sum(n.bytes_ for n in hit_nodes if not n.in_gpu)
        for name, toks in zip(("gpu", "host", "disk"), tier_tokens):
            tree.stats[f"hit_tokens_{name}"] += toks
        self.total_docs += len(doc_ids)
        self.total_hit_docs += len(hit_nodes)
        tree.stats["hits" if hit_nodes else "misses"] += 1
        return RequestPlan(
            doc_ids=tuple(int(d) for d in doc_ids),
            doc_tokens=tuple(int(t) for t in doc_tokens),
            question_tokens=question_tokens,
            hit_nodes=hit_nodes,
            alpha=alpha,
            beta=beta,
            promote_bytes=promote,
            hit_docs=len(hit_nodes),
            hit_tier_tokens=tuple(tier_tokens),
            chunks=chunks,
            exact=exact_so_far,
        )

    # ---- corpus preloading (--mode cag; docs/ARCHITECTURE.md §12) ----------

    def preload_corpus(self, doc_ids: Sequence[int],
                       doc_tokens: Sequence[int], payload_of=None, *,
                       log=None, log_every: int = 64) -> dict:
        """Pre-insert the FULL corpus KV into the tree's disk tier (CAG
        startup).  Every doc becomes a root child via the O(1)
        ``preload_disk`` path — no eviction scans, no transient GPU/host
        residency — so preloading a corpus is linear in corpus size and
        raises EvictionError loudly if the disk budget cannot hold it.

        ``payload_of(doc_id, n_tokens)`` produces the host-layout KV payload
        to spill (None = accounting-only, the simulator's mode).  ``log`` is
        an optional progress callback called every ``log_every`` docs and at
        the end with (docs_done, total_docs, bytes_so_far).  Returns
        ``{"docs", "tokens", "bytes", "files", "seconds"}`` — ``files`` is
        the number of disk segments actually written (spill hops taken;
        already-resident docs are skipped and don't write)."""
        tree = self.tree
        stats = {"docs": 0, "tokens": 0, "bytes": 0, "files": 0,
                 "seconds": 0.0}
        total = len(doc_ids)
        for i, (d, n_tok) in enumerate(zip(doc_ids, doc_tokens)):
            d, n_tok = int(d), int(n_tok)
            existing = tree.root.children.get(d)
            if existing is not None and existing.cached:
                continue
            payload = payload_of(d, n_tok) if payload_of is not None else None
            node, t = tree.preload_disk(d, n_tok, payload)
            stats["docs"] += 1
            stats["tokens"] += n_tok
            stats["bytes"] += node.bytes_
            stats["files"] += 1
            stats["seconds"] += t
            if log is not None and (i + 1) % log_every == 0:
                log(i + 1, total, stats["bytes"])
        if log is not None:
            log(total, total, stats["bytes"])
        return stats

    # ---- execution hooks ----------------------------------------------------

    def promote(self, plan: RequestPlan) -> float:
        """Pull the hit prefix into GPU; returns transfer seconds."""
        for n in plan.hit_nodes:
            n.pinned = True
        try:
            return self.tree.ensure_in_gpu(plan.hit_nodes)
        except EvictionError:
            # degenerate: cache thrash — drop the hit, full recompute.
            # Roll back BOTH tier-attribution channels (the plan's own split
            # and the tree's running counters): nothing was actually served
            for n in plan.hit_nodes:
                n.pinned = False
            for name, toks in zip(("gpu", "host", "disk"),
                                  plan.hit_tier_tokens):
                self.tree.stats[f"hit_tokens_{name}"] -= toks
            plan.hit_nodes, plan.alpha = [], 0
            plan.beta = sum(plan.doc_tokens) + plan.question_tokens
            plan.promote_bytes = 0
            plan.hit_tier_tokens = (0, 0, 0)
            if plan.chunks is not None:
                # chunk mode: every position falls back to a fresh compute
                # — which is exact again (nothing relocated anymore)
                plan.chunks = [ChunkItem("miss", it.doc_id, it.n_tokens,
                                         None) for it in plan.chunks]
                plan.exact = True
            return 0.0

    def commit(self, plan: RequestPlan,
               payloads: Optional[Sequence[object]] = None,
               max_docs: Optional[int] = None) -> List[Node]:
        """After prefill: insert newly computed doc nodes (GPU tier), run
        Alg. 1 UPDATE_NODE for every accessed doc, unpin. Returns the list
        of newly inserted nodes (in path order) so callers managing real
        payload storage can reclaim payloads the tree did not take.

        max_docs (paper §8 "Large top-k"): cache only the first ``max_docs``
        documents of the sequence — permutation explosion makes deep tails
        unlikely to be reused, so trading tail coverage for cache space
        raises overall hit rate at large top-k."""
        tree = self.tree
        parent = plan.hit_nodes[-1] if plan.hit_nodes else tree.root
        pinned = set(plan.hit_nodes)
        new_nodes: List[Node] = []
        limit = len(plan.doc_ids) if max_docs is None else min(
            max_docs, len(plan.doc_ids))
        for i in range(len(plan.hit_nodes), limit):
            payload = payloads[i - len(plan.hit_nodes)] if payloads else None
            try:
                node, _ = tree.insert(parent, plan.doc_ids[i],
                                      plan.doc_tokens[i], payload,
                                      pinned=pinned | set(new_nodes))
            except EvictionError:
                break  # cache too small for this path — skip the tail
            new_nodes.append(node)
            parent = node
        # Alg. 1 stat updates: every accessed doc node
        for n in plan.hit_nodes:
            tree.update_on_access(n, True, plan.alpha, plan.beta)
        for n in new_nodes:
            tree.update_on_access(n, False, plan.alpha, plan.beta)
        for n in plan.hit_nodes:
            n.pinned = False
        return new_nodes

    def commit_chunks(self, plan: RequestPlan,
                      payloads: Optional[Sequence[object]] = None,
                      max_docs: Optional[int] = None) -> List[Node]:
        """Chunk-mode commit: every MISS doc inserts as a root child (the
        flat chunk cache) recording the doc context it was computed after
        (``src_prefix``/``exact_ctx``).  Relocated boundary segments are
        request-private and never commit — the canonical cache entry for a
        reloc hit is the node already resident.  ``payloads`` aligns with
        the MISS positions in order.  Returns newly inserted nodes so
        callers managing real storage can reclaim declined payloads."""
        tree = self.tree
        assert plan.chunks is not None, "commit_chunks needs a chunk plan"
        pinned = set(plan.hit_nodes)
        new_nodes: List[Node] = []
        limit = len(plan.chunks) if max_docs is None else min(
            max_docs, len(plan.chunks))
        pi = 0
        exact_so_far = True
        for i, it in enumerate(plan.chunks):
            if it.kind == "reloc":
                # everything materialized after a relocated chunk was
                # computed over approximate context
                exact_so_far = False
                continue
            if it.kind != "miss":
                continue
            payload = None
            if payloads is not None and pi < len(payloads):
                payload = payloads[pi]
            pi += 1
            if i >= limit:
                continue
            existing = tree.root.children.get(it.doc_id)
            if existing is not None and existing.cached:
                # a concurrent prefill committed this doc between plan and
                # commit: the incumbent (with ITS src_prefix) is canonical —
                # taking our payload would attach KV computed after a
                # different context to its metadata.  Caller reclaims ours.
                continue
            try:
                node, _ = tree.insert(tree.root, it.doc_id, it.n_tokens,
                                      payload,
                                      pinned=pinned | set(new_nodes))
            except EvictionError:
                continue     # chunk cache too small for this doc: skip it
            node.src_prefix = tuple(plan.doc_ids[:i])
            node.exact_ctx = exact_so_far
            new_nodes.append(node)
        for n in plan.hit_nodes:
            tree.update_on_access(n, True, plan.alpha, plan.beta)
        for n in new_nodes:
            tree.update_on_access(n, False, plan.alpha, plan.beta)
        for n in plan.hit_nodes:
            n.pinned = False
        return new_nodes

    # ---- metrics ------------------------------------------------------------

    @property
    def doc_hit_rate(self) -> float:
        """Paper §7.3: hit documents / retrieved documents."""
        return self.total_hit_docs / max(self.total_docs, 1)
