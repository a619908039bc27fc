"""Production traffic model: multi-tenant, non-stationary request streams.

``corpus.make_workload`` is a single-tenant stationary Poisson/Zipf stream;
the RAG systems trade-offs study (arXiv 2412.11854) shows that the request
*mix* — tenant skew, burstiness, output-length distribution — dominates
end-to-end behavior, and none of it is measurable on a stationary stream.
This module generates the load the front-door subsystem
(``serving/frontdoor.py``) is built to absorb:

  * **multi-tenant corpora** — each ``TenantSpec`` owns a slice of the
    corpus, its own Zipf doc-popularity skew, question/output-length shape,
    and a TTFT SLO the admission layer enforces;
  * **canonical query pools** — real users repeat themselves: each tenant
    draws from a finite pool of canonical queries (Zipf-skewed by query
    rank), so repeated queries carry *identical* question tokens and query
    vectors (exact front-door hits) and near-duplicates carry jittered
    vectors with mutated tokens (similarity hits);
  * **diurnal rate modulation** — a sinusoid over the arrival rate
    (``diurnal_amplitude``/``diurnal_period``);
  * **Markov-modulated bursts** — a two-state (calm/burst) modulated
    Poisson process: in the burst state the instantaneous rate is
    multiplied by ``burst_rate_mult``; state transitions are sampled per
    arrival.

The generator emits the existing ``retrieval.corpus.Request`` type (with
the optional ``tenant``/``query_id`` fields filled in), so the sequential
engine, the continuous runtime and the simulator all consume the stream
unchanged.

The port's copy of ``repro.retrieval.traffic``, statement for statement
(``tests/test_torch_imports.py`` holds the two together); the simulator
and benchmarks named above are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.retrieval.corpus import Corpus, Request


@dataclasses.dataclass
class TenantSpec:
    """One tenant's traffic shape and service-level objective."""
    name: str
    weight: float = 1.0            # share of fleet traffic (normalized)
    zipf_s: float = 1.0            # doc-popularity skew in the tenant slice
    slo_ttft_ms: float = 500.0     # TTFT target the admission layer enforces
    n_queries: int = 64            # canonical query pool size (smaller =
    #                                more repeats = higher front-door hit rate)
    query_zipf_s: float = 1.0      # query-popularity skew within the pool
    near_dup_prob: float = 0.0     # prob a repeat is a near-duplicate
    #                                (jittered vector + mutated tokens —
    #                                similarity hit, never an exact hit)
    question_tokens: int = 32
    output_len_mean: int = 1
    doc_lo: float = 0.0            # tenant's corpus slice [doc_lo, doc_hi)
    doc_hi: float = 1.0            # as fractions of the doc-id space
    min_top_k: int = 1             # degrade floor for SLO admission


def default_tenants(n: int, *, slo_ttft_ms: float = 500.0,
                    zipf_s: float = 1.2,
                    n_queries: int = 64) -> List[TenantSpec]:
    """N tenants with the canonical production shape: a heavy head tenant
    and a tail of lighter ones (weights 1/rank), disjoint corpus slices,
    tighter SLOs for the head (paying) tenants."""
    out = []
    for i in range(max(1, n)):
        lo = i / max(1, n)
        hi = (i + 1) / max(1, n)
        out.append(TenantSpec(
            name=f"tenant{i}",
            weight=1.0 / (i + 1),
            zipf_s=zipf_s,
            slo_ttft_ms=slo_ttft_ms * (1.0 + 0.5 * i),
            n_queries=n_queries,
            doc_lo=lo, doc_hi=hi,
        ))
    return out


@dataclasses.dataclass
class TrafficConfig:
    n_requests: int
    base_rate: float               # mean arrival rate (req/s) before modulation
    diurnal_amplitude: float = 0.0  # 0..1: rate swings base*(1 +/- amplitude)
    diurnal_period: float = 60.0   # seconds per simulated "day"
    burst_rate_mult: float = 1.0   # burst-state rate multiplier (1 = off)
    burst_on_prob: float = 0.05    # calm->burst transition prob per arrival
    burst_off_prob: float = 0.3    # burst->calm transition prob per arrival
    query_noise: float = 0.05      # canonical query vec = doc vec + this
    near_dup_noise: float = 0.02   # extra jitter on near-duplicate vectors
    vocab: int = 32000
    seed: int = 1
    drift: float = 0.0             # fraction of each tenant's doc ranks
    #                                reshuffled per phase (non-stationarity)
    n_phases: int = 8


@dataclasses.dataclass
class _QueryPool:
    """A tenant's canonical queries: repeated draws of query ``q`` emit the
    exact same vector + tokens, so the front door's exact cache can hit."""
    vecs: np.ndarray               # (n_queries, d)
    tokens: List[np.ndarray]
    targets: np.ndarray            # (n_queries,) target doc per query
    probs: np.ndarray              # (n_queries,) Zipf query popularity


def _zipf(n: int, s: float, rng: np.random.Generator) -> np.ndarray:
    ranks = rng.permutation(n) + 1
    p = 1.0 / ranks.astype(np.float64) ** s
    return p / p.sum()


def _build_pool(corpus: Corpus, t: TenantSpec, cfg: TrafficConfig,
                rng: np.random.Generator) -> _QueryPool:
    n_docs = len(corpus.doc_lengths)
    lo = int(t.doc_lo * n_docs)
    hi = max(lo + 1, int(t.doc_hi * n_docs))
    slice_ids = np.arange(lo, hi)
    doc_p = _zipf(len(slice_ids), t.zipf_s, rng)
    n_q = max(1, t.n_queries)
    targets = slice_ids[rng.choice(len(slice_ids), size=n_q, p=doc_p)]
    d = corpus.doc_vectors.shape[1]
    vecs = (corpus.doc_vectors[targets]
            + rng.normal(scale=cfg.query_noise, size=(n_q, d))
            ).astype(np.float32)
    toks = [rng.integers(0, cfg.vocab, t.question_tokens).astype(np.int32)
            for _ in range(n_q)]
    return _QueryPool(vecs=vecs, tokens=toks, targets=targets,
                      probs=_zipf(n_q, t.query_zipf_s, rng))


def make_tenant_workload(corpus: Corpus, tenants: Sequence[TenantSpec],
                         cfg: TrafficConfig) -> List[Request]:
    """Generate the multi-tenant trace.  Deterministic per ``cfg.seed``."""
    if not tenants:
        raise ValueError("need at least one TenantSpec")
    rng = np.random.default_rng(cfg.seed)
    pools = [_build_pool(corpus, t, cfg, rng) for t in tenants]
    weights = np.asarray([max(t.weight, 1e-9) for t in tenants], np.float64)
    weights /= weights.sum()

    # non-stationary phases: reshuffle a fraction of each pool's query
    # popularity ranks at phase boundaries (same knob as make_workload's
    # drift, applied to the query pool so repeats stay exact)
    bounds = np.linspace(0, cfg.n_requests, max(1, cfg.n_phases) + 1)
    bounds = bounds.astype(int)

    out: List[Request] = []
    t_now = 0.0
    burst = False
    phase = 0
    for i in range(cfg.n_requests):
        while phase + 1 < len(bounds) - 1 and i >= bounds[phase + 1]:
            phase += 1
            if cfg.drift > 0.0:
                for pool in pools:
                    n_q = len(pool.probs)
                    k = max(2, int(cfg.drift * n_q))
                    if k <= n_q:
                        idx = rng.choice(n_q, size=k, replace=False)
                        pool.probs[idx] = pool.probs[rng.permutation(idx)]
                        pool.probs /= pool.probs.sum()
        # Markov-modulated Poisson: transition, then draw the gap at the
        # current instantaneous rate (diurnal x burst modulation)
        if burst:
            if rng.random() < cfg.burst_off_prob:
                burst = False
        elif rng.random() < cfg.burst_on_prob and cfg.burst_rate_mult > 1.0:
            burst = True
        rate = cfg.base_rate
        if cfg.diurnal_amplitude > 0.0:
            rate *= 1.0 + cfg.diurnal_amplitude * np.sin(
                2.0 * np.pi * t_now / max(cfg.diurnal_period, 1e-9))
        if burst:
            rate *= cfg.burst_rate_mult
        t_now += rng.exponential(1.0 / max(rate, 1e-9))

        ti = int(rng.choice(len(tenants), p=weights))
        tenant, pool = tenants[ti], pools[ti]
        q = int(rng.choice(len(pool.probs), p=pool.probs))
        vec = pool.vecs[q]
        toks = pool.tokens[q]
        if tenant.near_dup_prob > 0.0 and rng.random() < tenant.near_dup_prob:
            # near-duplicate: semantically the same query, phrased slightly
            # differently — the exact hash misses, the similarity probe hits
            vec = (vec + rng.normal(scale=cfg.near_dup_noise,
                                    size=vec.shape).astype(np.float32))
            toks = toks.copy()
            toks[rng.integers(0, len(toks))] = rng.integers(0, cfg.vocab)
        if tenant.output_len_mean <= 1:
            olen = 1
        else:
            olen = int(np.clip(rng.geometric(1.0 / tenant.output_len_mean),
                               1, 32))
        out.append(Request(
            req_id=i,
            arrival=float(t_now),
            query_vec=np.asarray(vec, np.float32),
            question_tokens=np.asarray(toks, np.int32),
            target_doc=int(pool.targets[q]),
            output_len=olen,
            tenant=tenant.name,
            query_id=q + 100000 * ti,   # globally unique per (tenant, query)
        ))
    return out


def tenant_slos(tenants: Sequence[TenantSpec]) -> Dict[str, float]:
    """name -> TTFT target in SECONDS (what SloAdmission consumes)."""
    return {t.name: t.slo_ttft_ms / 1e3 for t in tenants}


def repeat_rate(requests: Sequence[Request]) -> float:
    """Fraction of requests whose (tenant, query_id) was seen before — the
    exact-hit ceiling for an infinite, never-expiring front-door cache."""
    seen: set = set()
    repeats = 0
    for r in requests:
        key = (r.tenant, r.query_id)
        if key in seen:
            repeats += 1
        seen.add(key)
    return repeats / max(len(requests), 1)


def split_by_tenant(requests: Sequence[Request]
                    ) -> Dict[str, List[Request]]:
    out: Dict[str, List[Request]] = {}
    for r in requests:
        out.setdefault(r.tenant, []).append(r)
    return out


def make_default_workload(corpus: Corpus, *, n_tenants: int = 2,
                          n_requests: int = 64, rate: float = 10.0,
                          slo_ttft_ms: float = 500.0, zipf_s: float = 1.2,
                          n_queries: int = 16, seed: int = 1,
                          drift: float = 0.0, n_phases: int = 8,
                          diurnal_amplitude: float = 0.0,
                          burst_rate_mult: float = 1.0,
                          vocab: int = 32000,
                          question_tokens: Optional[int] = None,
                          output_len_mean: int = 1,
                          ) -> tuple:
    """One-call setup for entry points: (tenants, requests).  Used by
    ``launch/serve.py --frontdoor/--tenants`` and the benchmarks."""
    tenants = default_tenants(n_tenants, slo_ttft_ms=slo_ttft_ms,
                              zipf_s=zipf_s, n_queries=n_queries)
    for t in tenants:
        if question_tokens is not None:
            t.question_tokens = question_tokens
        t.output_len_mean = output_len_mean
    cfg = TrafficConfig(n_requests=n_requests, base_rate=rate, seed=seed,
                        drift=drift, n_phases=n_phases,
                        diurnal_amplitude=diurnal_amplitude,
                        burst_rate_mult=burst_rate_mult, vocab=vocab)
    return tenants, make_tenant_workload(corpus, tenants, cfg)
