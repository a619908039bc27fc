"""Per-request serving telemetry for the continuous-batching runtime.

Each request gets a ``RequestTimeline`` of absolute timestamps on the
runtime's clock (arrival, retrieval stages, prefill, first token, decode
tokens).  ``ServingMetrics`` aggregates timelines plus per-iteration engine
records into the paper's headline numbers — TTFT / TPOT / queueing-time
percentiles, decode-batch occupancy, retrieval-overlap accounting (how
much of the staged vector search was hidden behind speculative prefill,
§5.3 / Fig. 19), and per-tier cache attribution: each request's cached
prefix split by the tier (gpu/host/disk) its hit nodes were resident in at
plan time, plus disk prefetches overlapped with search.

``FleetMetrics`` layers the multi-replica view on top (docs/ARCHITECTURE.md
§8): one ``ServingMetrics`` per replica plus the ``ReplicaRouter``'s
routing accounting, aggregated into per-replica occupancy / hit-token
tiers / routed-vs-escaped counts and cross-replica TTFT percentiles
computed over the POOLED per-request timelines (exact, not a mean of
per-replica percentiles).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class RequestTimeline:
    req_id: int
    arrival: float
    search_start: float = -1.0
    search_end: float = -1.0
    # first time *any* prefill (speculative or final) for the finally-chosen
    # document set started — the overlap credit (paper Fig. 19)
    final_prefill_start: float = -1.0
    prefill_end: float = -1.0
    queue_enter: float = -1.0          # final docs queued for the engine
    first_token: float = -1.0
    finish: float = -1.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    # cache accounting
    alpha: int = 0                     # cached prefix tokens
    beta: int = 0                      # computed tokens
    # alpha split by the tier each hit node was resident in at plan time
    hit_tokens_gpu: int = 0
    hit_tokens_host: int = 0
    hit_tokens_disk: int = 0
    hit_docs: int = 0
    n_docs: int = 0
    speculative_hit: bool = False      # final docs matched a live speculation
    preemptions: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    docs: tuple = ()

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival if self.first_token >= 0 else -1.0

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (paper §8)."""
        if not self.token_times or self.first_token < 0:
            return 0.0
        return (self.token_times[-1] - self.first_token) / len(self.token_times)

    @property
    def queueing(self) -> float:
        """Final-docs queue entry -> prefill start (scheduling delay)."""
        if self.queue_enter < 0 or self.final_prefill_start < 0:
            return 0.0
        return max(0.0, self.final_prefill_start - self.queue_enter)

    @property
    def search_time(self) -> float:
        if self.search_end < 0:
            return 0.0
        return self.search_end - self.search_start

    @property
    def non_overlapped_search(self) -> float:
        """Portion of the staged search NOT hidden behind a prefill of the
        final document set. Sequential serving: == search_time."""
        dur = self.search_time
        if self.final_prefill_start < 0:
            return dur
        overlap = max(0.0, self.search_end
                      - max(self.search_start, self.final_prefill_start))
        return max(0.0, dur - min(overlap, dur))


def percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0}
    a = np.asarray(xs, np.float64)
    return {
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p90": float(np.percentile(a, 90)),
        "p99": float(np.percentile(a, 99)),
        "max": float(a.max()),
    }


class ServingMetrics:
    """Aggregator owned by the runtime; benchmarks and the launch scripts read
    ``summary()`` / ``format_report()``."""

    def __init__(self):
        self.timelines: Dict[int, RequestTimeline] = {}
        # per engine iteration: ("prefill", 1) or ("decode", batch_size)
        self.iterations: List[tuple] = []
        self.wasted_prefills = 0
        self.spec_prefills = 0
        # staged-retrieval events processed (one per search stage).  CAG
        # mode's zero-retrieval-stage invariant asserts this stays 0.
        self.retrieval_stages = 0
        self.preemptions = 0
        self.blocks_shared = 0         # tree blocks refcounted into tables
        self.blocks_copied = 0         # unaligned doc tokens re-put privately
        # disk tier: prefetches issued during retrieval stages (overlapped
        # host-side I/O — see runtime._prefetch_disk)
        self.disk_prefetches = 0
        self.disk_prefetch_bytes = 0
        # chunked/batched prefill accounting
        # per prefill iteration: (n_chunks_packed, tokens_computed)
        self.prefill_batches: List[tuple] = []
        self.prefill_token_budget = 0  # max_prefill_tokens (0 = unbounded)
        self.chunks_cancelled = 0      # prefills aborted at a chunk boundary
        self.chunk_tokens_saved = 0    # prefill tokens NOT computed thanks to
                                       # mid-prefill cancellation
        # chunk-cache reuse (--reuse chunk, docs/ARCHITECTURE.md §11)
        self.exact_chunk_hits = 0      # docs reused bit-identically
        self.reloc_chunk_hits = 0      # docs reused at a new position
        self.reloc_recompute_tokens = 0   # boundary tokens recomputed

    def record_prefill_batch(self, n_chunks: int, n_tokens: int) -> None:
        self.prefill_batches.append((n_chunks, n_tokens))

    def record_chunk_cancel(self, tokens_saved: int) -> None:
        self.chunks_cancelled += 1
        self.chunk_tokens_saved += int(tokens_saved)

    def timeline(self, req_id: int, arrival: float) -> RequestTimeline:
        tl = self.timelines.get(req_id)
        if tl is None:
            tl = RequestTimeline(req_id=req_id, arrival=arrival)
            self.timelines[req_id] = tl
        return tl

    def record_iteration(self, kind: str, batch: int) -> None:
        self.iterations.append((kind, batch))

    # ---- aggregation ------------------------------------------------------

    def completed(self) -> List[RequestTimeline]:
        return [t for t in self.timelines.values() if t.first_token >= 0]

    def summary(self) -> Dict[str, object]:
        done = self.completed()
        decode_batches = [b for k, b in self.iterations if k == "decode"]
        n_prefills = sum(1 for k, _ in self.iterations if k == "prefill")
        spec_hits = sum(1 for t in done if t.speculative_hit)
        chunk_counts = [c for c, _ in self.prefill_batches]
        chunk_tokens = [t for _, t in self.prefill_batches]
        budget = self.prefill_token_budget
        return {
            "completed": len(done),
            "ttft": percentiles([t.ttft for t in done]),
            "tpot": percentiles([t.tpot for t in done if t.token_times]),
            "queueing": percentiles([t.queueing for t in done]),
            "search": percentiles([t.search_time for t in done]),
            "non_overlapped_search": percentiles(
                [t.non_overlapped_search for t in done]),
            "decode_iterations": len(decode_batches),
            "prefill_iterations": n_prefills,
            "mean_decode_batch": (float(np.mean(decode_batches))
                                  if decode_batches else 0.0),
            "max_decode_batch": max(decode_batches, default=0),
            "speculative_hits": spec_hits,
            "speculative_prefills": self.spec_prefills,
            "retrieval_stages": self.retrieval_stages,
            "wasted_prefills": self.wasted_prefills,
            "preemptions": self.preemptions,
            "prefill_chunks": int(sum(chunk_counts)),
            "prefill_batch_occupancy": (float(np.mean(chunk_counts))
                                        if chunk_counts else 0.0),
            "max_prefill_batch": max(chunk_counts, default=0),
            "prefill_token_fill": (
                float(np.mean(chunk_tokens)) / budget
                if budget > 0 and chunk_tokens else 0.0),
            "chunks_cancelled": self.chunks_cancelled,
            "chunk_tokens_saved": self.chunk_tokens_saved,
            "exact_chunk_hits": self.exact_chunk_hits,
            "reloc_chunk_hits": self.reloc_chunk_hits,
            "reloc_recompute_tokens": self.reloc_recompute_tokens,
            "blocks_shared": self.blocks_shared,
            "blocks_copied": self.blocks_copied,
            "tier_hit_tokens": {
                "gpu": sum(t.hit_tokens_gpu for t in done),
                "host": sum(t.hit_tokens_host for t in done),
                "disk": sum(t.hit_tokens_disk for t in done),
            },
            "disk_prefetches": self.disk_prefetches,
            "disk_prefetch_bytes": self.disk_prefetch_bytes,
            "doc_hit_rate": (sum(t.hit_docs for t in done)
                             / max(sum(t.n_docs for t in done), 1)),
        }

    def format_report(self) -> str:
        s = self.summary()

        def ms(p):
            return (f"mean {p['mean'] * 1e3:7.1f}  p50 {p['p50'] * 1e3:7.1f}"
                    f"  p90 {p['p90'] * 1e3:7.1f}  p99 {p['p99'] * 1e3:7.1f}")

        lines = [
            f"completed requests      : {s['completed']}",
            f"TTFT (ms)               : {ms(s['ttft'])}",
            f"TPOT (ms)               : {ms(s['tpot'])}",
            f"queueing (ms)           : {ms(s['queueing'])}",
            f"search (ms)             : {ms(s['search'])}",
            f"non-overlapped search   : {ms(s['non_overlapped_search'])}",
            f"engine iterations       : {s['prefill_iterations']} prefill / "
            f"{s['decode_iterations']} decode",
            f"decode batch occupancy  : mean {s['mean_decode_batch']:.2f} "
            f"max {s['max_decode_batch']}",
            f"speculation             : {s['speculative_hits']} hits / "
            f"{s['speculative_prefills']} launched / "
            f"{s['wasted_prefills']} wasted",
            f"preemptions             : {s['preemptions']}",
            f"prefill chunks          : {s['prefill_chunks']} run / "
            f"{s['chunks_cancelled']} cancelled mid-prefill / "
            f"{s['chunk_tokens_saved']} tokens saved",
            f"prefill batch occupancy : mean {s['prefill_batch_occupancy']:.2f} "
            f"max {s['max_prefill_batch']} "
            f"fill {s['prefill_token_fill']:.2f}",
            f"paged blocks            : {s['blocks_shared']} shared / "
            f"{s['blocks_copied']} copied",
            f"cache hit tokens        : gpu {s['tier_hit_tokens']['gpu']} / "
            f"host {s['tier_hit_tokens']['host']} / "
            f"disk {s['tier_hit_tokens']['disk']}",
            f"disk prefetches         : {s['disk_prefetches']} "
            f"({s['disk_prefetch_bytes']} B overlapped with search)",
            f"doc hit rate            : {s['doc_hit_rate']:.2%}",
        ]
        return "\n".join(lines)


class FleetMetrics:
    """Cross-replica aggregation for multi-replica serving.

    The caller adds each replica's ``ServingMetrics`` after serving and
    attaches the router's ``stats()`` dict; ``summary()`` pools every
    replica's completed timelines so the cross-replica TTFT/TPOT
    percentiles are exact."""

    def __init__(self, router_stats: Dict[str, object] | None = None,
                 frontdoor_stats: Dict[str, object] | None = None):
        self.replicas: List[Tuple[str, ServingMetrics]] = []
        self.router_stats: Dict[str, object] = router_stats or {}
        # serving/frontdoor.py FrontDoor.stats(): query-cache hit rates,
        # per-tenant SLO attainment, shed counts, autoscale events
        self.frontdoor_stats: Dict[str, object] = frontdoor_stats or {}

    def add_replica(self, name: str, metrics: ServingMetrics) -> None:
        self.replicas.append((name, metrics))

    def summary(self) -> Dict[str, object]:
        done = [t for _, m in self.replicas for t in m.completed()]
        per_replica = []
        for name, m in self.replicas:
            s = m.summary()
            per_replica.append({
                "name": name,
                "completed": s["completed"],
                "decode_occupancy": s["mean_decode_batch"],
                "prefill_occupancy": s["prefill_batch_occupancy"],
                "tier_hit_tokens": s["tier_hit_tokens"],
                "blocks_shared": s["blocks_shared"],
                "preemptions": s["preemptions"],
            })
        tiers = {t: sum(r["tier_hit_tokens"][t] for r in per_replica)
                 for t in ("gpu", "host", "disk")}
        return {
            "replicas": len(self.replicas),
            "completed": len(done),
            "ttft": percentiles([t.ttft for t in done]),
            "tpot": percentiles([t.tpot for t in done if t.token_times]),
            "tier_hit_tokens": tiers,
            "per_replica": per_replica,
            "routing": dict(self.router_stats),
            "frontdoor": dict(self.frontdoor_stats),
        }

    def format_report(self) -> str:
        s = self.summary()
        p = s["ttft"]
        rs = s["routing"]
        kinds = rs.get("kind_counts", {})
        routed = rs.get("routed", [])
        escaped = rs.get("escaped", 0)
        lines = [
            f"fleet: {s['replicas']} replicas, {s['completed']} completed, "
            f"policy {rs.get('policy', '?')}",
            f"cross-replica TTFT (ms) : mean {p['mean'] * 1e3:7.1f}  "
            f"p50 {p['p50'] * 1e3:7.1f}  p99 {p['p99'] * 1e3:7.1f}",
            f"routed per replica      : {routed}  "
            f"(escaped {escaped}, max skew {rs.get('max_skew_observed', 0)}"
            f"/{rs.get('max_queue_skew', '?')} bound)",
            f"decision kinds          : "
            + (", ".join(f"{k} {v}" for k, v in sorted(kinds.items()))
               or "none"),
            f"fleet hit tokens        : gpu {s['tier_hit_tokens']['gpu']} / "
            f"host {s['tier_hit_tokens']['host']} / "
            f"disk {s['tier_hit_tokens']['disk']}",
        ]
        for r in s["per_replica"]:
            lines.append(
                f"  {r['name']:<12} completed {r['completed']:>4}  "
                f"decode occ {r['decode_occupancy']:.2f}  "
                f"prefill occ {r['prefill_occupancy']:.2f}  "
                f"hit gpu/host/disk {r['tier_hit_tokens']['gpu']}/"
                f"{r['tier_hit_tokens']['host']}/"
                f"{r['tier_hit_tokens']['disk']}  "
                f"shared {r['blocks_shared']}  "
                f"preempt {r['preemptions']}")
        fd = s["frontdoor"]
        if fd:
            cache = fd.get("cache", {})
            lines.append(
                f"front door              : hit rate {fd.get('hit_rate', 0.0):.2%} "
                f"(exact {cache.get('hits_exact', 0)} / "
                f"similar {cache.get('hits_similar', 0)} / "
                f"miss {cache.get('misses', 0)}), "
                f"shed {fd.get('shed_total', 0)}, "
                f"degraded {fd.get('degraded', 0)}, "
                f"cache {cache.get('size', 0)}/{cache.get('capacity', 0)} "
                f"(expired {cache.get('expired', 0)}, "
                f"evicted {cache.get('evicted', 0)})")
            targets = fd.get("slo_targets_ms", {})
            for tenant, att in sorted(fd.get("slo_attainment", {}).items()):
                tgt = targets.get(tenant)
                tgt_s = f" (target {tgt:.0f}ms)" if tgt is not None else ""
                lines.append(
                    f"  SLO {tenant or '<default>':<12} "
                    f"attained {att['attained']}/{att['completed']} "
                    f"= {att['fraction']:.2%}{tgt_s}")
            scale = fd.get("autoscale")
            if scale:
                lines.append(
                    f"autoscale               : active {scale['active']} "
                    f"in [{scale['min_replicas']}, {scale['max_replicas']}] "
                    f"(seen {scale['min_seen']}..{scale['max_seen']}, "
                    f"{len(scale['events'])} events)")
                for t, active, reason in scale["events"]:
                    lines.append(f"  t={t:8.3f}s -> {active} ({reason})")
        return "\n".join(lines)
