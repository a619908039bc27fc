"""Synthetic knowledge corpus + QA workloads reproducing the paper's
characterization (§3.2): document lengths follow the Wikipedia-like long
distribution (mean ~3718 tokens in the paper; scaled down for CPU runs) and
the retrieval pattern is Zipf-skewed (top 3% of docs ≈ 60% of requests on
MMLU).  Queries embed as their target document's vector + noise, so ANN
retrieval reproduces the skew end-to-end rather than by construction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Corpus:
    doc_vectors: np.ndarray        # (N, d) unit vectors
    doc_tokens: List[np.ndarray]   # token ids per document
    doc_lengths: np.ndarray        # (N,)


@dataclasses.dataclass
class Request:
    req_id: int
    arrival: float                 # seconds
    query_vec: np.ndarray
    question_tokens: np.ndarray
    target_doc: int
    output_len: int
    # multi-tenant traffic model (retrieval/traffic.py); engines ignore these
    tenant: str = ""               # tenant name ("" = single-tenant workload)
    query_id: int = -1             # canonical query id (repeats share one id)
    top_k: int = 0                 # per-request retrieval depth override
    #                                (0 = engine default; the front door's
    #                                SLO admission degrades requests by
    #                                lowering this, serving/frontdoor.py)


def make_corpus(
    n_docs: int,
    embed_dim: int = 32,
    mean_doc_tokens: int = 192,
    vocab: int = 32000,
    seed: int = 0,
) -> Corpus:
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n_docs, embed_dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    # long-ish lognormal doc lengths (paper Fig. 3: docs >> questions)
    lens = np.clip(
        rng.lognormal(np.log(mean_doc_tokens), 0.4, n_docs), 16, 8 * mean_doc_tokens
    ).astype(int)
    toks = [rng.integers(0, vocab, size=l).astype(np.int32) for l in lens]
    return Corpus(vecs, toks, lens)


def zipf_popularity(n_docs: int, s: float = 1.0, seed: int = 0) -> np.ndarray:
    """Zipf document popularity with a random rank permutation (the popular
    docs are arbitrary ids, as in real corpora)."""
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(n_docs) + 1
    p = 1.0 / ranks.astype(np.float64) ** s
    return p / p.sum()


def make_workload(
    corpus: Corpus,
    *,
    n_requests: int,
    rate: float,                   # Poisson arrival rate (req/s)
    zipf_s: float = 1.0,
    question_tokens: int = 32,
    output_len_mean: int = 1,      # 1 => MMLU-like; ~6 => NaturalQuestions-like
    query_noise: float = 0.05,
    vocab: int = 32000,
    seed: int = 1,
    drift: float = 0.0,            # fraction of popularity ranks reshuffled
                                   # per workload phase (temporal locality;
                                   # real QA traffic is non-stationary)
    n_phases: int = 8,
) -> List[Request]:
    rng = np.random.default_rng(seed)
    n_docs = len(corpus.doc_lengths)
    if drift > 0.0:
        ranks = rng.permutation(n_docs) + 1
        targets = np.empty(n_requests, np.int64)
        bounds = np.linspace(0, n_requests, n_phases + 1).astype(int)
        for ph in range(n_phases):
            if ph:
                k = max(2, int(drift * n_docs))
                idx = rng.choice(n_docs, size=k, replace=False)
                ranks[idx] = ranks[rng.permutation(idx)]
            p = 1.0 / ranks.astype(np.float64) ** zipf_s
            p /= p.sum()
            lo, hi = bounds[ph], bounds[ph + 1]
            targets[lo:hi] = rng.choice(n_docs, size=hi - lo, p=p)
    else:
        pop = zipf_popularity(n_docs, zipf_s, seed)
        targets = rng.choice(n_docs, size=n_requests, p=pop)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    out = []
    for i in range(n_requests):
        t = targets[i]
        q = corpus.doc_vectors[t] + rng.normal(
            scale=query_noise, size=corpus.doc_vectors.shape[1]
        ).astype(np.float32)
        if output_len_mean <= 1:
            olen = 1
        else:
            olen = int(np.clip(rng.geometric(1.0 / output_len_mean), 1, 32))
        out.append(Request(
            req_id=i,
            arrival=float(arrivals[i]),
            query_vec=q,
            question_tokens=rng.integers(0, vocab, question_tokens).astype(np.int32),
            target_doc=int(t),
            output_len=olen,
        ))
    return out


def access_cdf(doc_ids: Sequence[int], n_docs: int) -> Tuple[np.ndarray, np.ndarray]:
    """CDF of accesses vs fraction of (sorted-by-popularity) documents —
    reproduces paper Fig. 5."""
    counts = np.bincount(np.asarray(doc_ids), minlength=n_docs).astype(np.float64)
    counts[::-1].sort()
    cdf = np.cumsum(counts) / max(counts.sum(), 1)
    frac_docs = np.arange(1, n_docs + 1) / n_docs
    return frac_docs, cdf
