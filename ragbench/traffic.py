"""Seeded RAG traffic for the benchmark.

``make_corpus``, ``zipf_popularity`` and ``make_workload`` are frozen copies
of ``repro_torch.retrieval.corpus``'s generator (the drift branch left out):
the yardstick may not move when the program's generator does.  They build the
program's own ``Corpus`` / ``Request`` dataclasses, which the runtime takes.

``build`` draws one run's traffic from a traffic file (``traffic/<name>.json``)
and the run's seed.  The work is fixed by the file's ``base_seed``: document
lengths, the document vectors (so the retrieval geometry), which popularity
rank each document has, the window's queries (each a requested document's
vector plus noise, so what they retrieve) and the set of gaps between
arrivals, and the warm-up's queries (so the cache the window starts from).
The order of the window's queries and of its gaps is fixed too: in a cache the
order decides which request hits, so a seed that reordered them changed the
work (PERF.md).  The run's seed draws the token ids of the documents and the
questions (and, in the harness, the weights).  So every seed serves the same
requests at the same due times, and the window holds exactly
``rate * seconds`` requests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.retrieval.corpus import Corpus, Request


def make_corpus(n_docs: int, embed_dim: int = 32, mean_doc_tokens: int = 192,
                vocab: int = 32000, seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n_docs, embed_dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    lens = np.clip(
        rng.lognormal(np.log(mean_doc_tokens), 0.4, n_docs), 16,
        8 * mean_doc_tokens).astype(int)
    toks = [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]
    return Corpus(vecs, toks, lens)


def zipf_popularity(n_docs: int, s: float = 1.0, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(n_docs) + 1
    p = 1.0 / ranks.astype(np.float64) ** s
    return p / p.sum()


def make_workload(corpus: Corpus, *, n_requests: int, rate: float,
                  zipf_s: float = 1.0, question_tokens: int = 32,
                  output_len_mean: int = 1, query_noise: float = 0.05,
                  vocab: int = 32000, seed: int = 1) -> List[Request]:
    rng = np.random.default_rng(seed)
    n_docs = len(corpus.doc_lengths)
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
            req_id=i, arrival=float(arrivals[i]), query_vec=q,
            question_tokens=rng.integers(0, vocab, question_tokens).astype(
                np.int32),
            target_doc=int(t), output_len=olen))
    return out


def stream(seed: int, name: str) -> np.random.Generator:
    """An independent generator for one purpose of one run's seed (any
    whole number, however large)."""
    key = [int(b) for b in name.encode()]
    return np.random.default_rng(np.random.SeedSequence([int(seed)] + key))


def sub_seed(seed: int, name: str) -> int:
    return int(stream(seed, name).integers(0, 2**62))


@dataclasses.dataclass
class Traffic:
    corpus: Corpus
    window: List[Request]          # due times in [0, seconds)
    warmup: List[Request]          # served unpaced before the window


def _requests(corpus: Corpus, targets, noise, arrivals, rng, t: dict,
              vocab: int, first_id: int) -> List[Request]:
    out = []
    for i, (doc, eps, due) in enumerate(zip(targets, noise, arrivals)):
        q = corpus.doc_vectors[doc] + eps
        out.append(Request(
            req_id=first_id + i, arrival=float(due), query_vec=q,
            question_tokens=rng.integers(
                0, vocab, t["question_tokens"]).astype(np.int32),
            target_doc=int(doc), output_len=t["max_new_tokens"]))
    return out


def build(t: Dict, seed: int, seconds: float, rate: float, vocab: int,
          n_warmup: int) -> Traffic:
    """One run's corpus, window requests and warm-up requests (see the
    module docstring for what the seed changes)."""
    base = int(t["base_seed"])
    corpus = make_corpus(t["n_docs"], t["embed_dim"], t["doc_tokens_median"],
                         vocab, seed=base)
    rng = stream(seed, "tokens")
    corpus.doc_tokens = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
                         for n in corpus.doc_lengths]
    pop = zipf_popularity(t["n_docs"], t["zipf_s"], base)
    n = int(round(rate * seconds))
    d = t["embed_dim"]
    fixed = np.random.default_rng(base + 1)
    targets = fixed.choice(t["n_docs"], size=n, p=pop)
    noise = fixed.normal(scale=t["query_noise"], size=(n, d))
    gaps = fixed.exponential(1.0, size=n + 1)
    arrivals = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
    window = _requests(corpus, targets, noise.astype(np.float32), arrivals,
                       stream(seed, "window"), t, vocab, 0)
    wfixed = np.random.default_rng(base + 2)
    wtargets = wfixed.choice(t["n_docs"], size=n_warmup, p=pop)
    wnoise = wfixed.normal(scale=t["query_noise"], size=(n_warmup, d))
    warmup = _requests(corpus, wtargets, wnoise.astype(np.float32),
                       np.zeros(n_warmup), stream(seed, "warmup"), t, vocab,
                       n)
    return Traffic(corpus, window, warmup)
