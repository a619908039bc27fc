"""Vector database with staged (pipelined) search — the substrate for
dynamic speculative pipelining (paper §5.3 / §6 "Pipelined vector search").

Two ANN indexes, as in the paper's implementation:

  * FlatL2  — exact scan; staged by splitting the database into shards.
  * IVF     — k-means clusters (Lloyd iterations in numpy); search probes the
              ``nprobe`` closest clusters, staged cluster-by-cluster so each
              stage returns the provisional top-k (the paper splits IVF
              search into multiple stages the same way).

Each stage reports an analytic CPU cost (bytes scanned / scan bandwidth) used
by the simulator; real wall-clock is also measured for the on-CPU benches.
Retrieval stays on the host, as Faiss-on-CPU does in the paper (counterpart
of ``repro.retrieval.vectordb``; only the k-means moved from JAX to numpy,
so its clusters differ from the JAX package's for the same seed).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

# effective CPU scan bandwidth for the analytic retrieval cost model
SCAN_BYTES_PER_S = 4e9


@dataclasses.dataclass
class SearchStage:
    topk: Tuple[int, ...]          # provisional top-k doc ids
    seconds: float                 # analytic stage cost
    fraction_searched: float       # cumulative fraction of vectors scanned
    is_final: bool


def _l2_topk(q: np.ndarray, vecs: np.ndarray, ids: np.ndarray, k: int):
    d = ((vecs - q[None]) ** 2).sum(axis=1)
    order = np.argsort(d)[:k]
    return [(float(d[i]), int(ids[i])) for i in order]


class FlatIndex:
    """Exact L2 scan, staged over equal shards of the database.

    ``scan_bytes_per_s`` calibrates the *analytic* stage cost the simulator
    consumes — lower values model higher-accuracy / larger-corpus searches
    (the paper's 78-446 ms regime, Table 3)."""

    def __init__(self, vectors: np.ndarray, n_stages: int = 4,
                 scan_bytes_per_s: float = SCAN_BYTES_PER_S):
        self.vectors = np.asarray(vectors, np.float32)
        self.n = self.vectors.shape[0]
        self.n_stages = max(1, n_stages)
        self.scan_bytes_per_s = scan_bytes_per_s

    def search(self, q: np.ndarray, k: int) -> List[int]:
        return [d for _, d in _l2_topk(q, self.vectors,
                                       np.arange(self.n), k)]

    def staged_search(self, q: np.ndarray, k: int,
                      fraction: float = 1.0) -> Iterator[SearchStage]:
        limit = max(1, int(self.n * fraction))
        bounds = np.linspace(0, limit, self.n_stages + 1).astype(int)
        pool: List[Tuple[float, int]] = []
        for si in range(self.n_stages):
            lo, hi = bounds[si], bounds[si + 1]
            if hi > lo:
                pool.extend(_l2_topk(q, self.vectors[lo:hi],
                                     np.arange(lo, hi), k))
                pool.sort()
                pool = pool[:k]
            sec = (hi - lo) * self.vectors.shape[1] * 4 / self.scan_bytes_per_s
            yield SearchStage(
                topk=tuple(d for _, d in pool),
                seconds=sec + 1e-4,
                fraction_searched=hi / self.n,
                is_final=(si == self.n_stages - 1),
            )


class IVFIndex:
    """Inverted-file index with k-means centroids, staged by probed cluster."""

    def __init__(self, vectors: np.ndarray, n_clusters: int = 64,
                 nprobe: int = 8, kmeans_iters: int = 8, seed: int = 0,
                 scan_bytes_per_s: float = SCAN_BYTES_PER_S):
        self.scan_bytes_per_s = scan_bytes_per_s
        self.vectors = np.asarray(vectors, np.float32)
        self.n, self.d = self.vectors.shape
        self.n_clusters = min(n_clusters, self.n)
        self.nprobe = min(nprobe, self.n_clusters)
        self.centroids, self.assign = self._kmeans(kmeans_iters, seed)
        self.lists = [np.nonzero(self.assign == c)[0]
                      for c in range(self.n_clusters)]

    def _kmeans(self, iters: int, seed: int):
        rng = np.random.default_rng(seed)
        x = self.vectors
        cent = x[rng.choice(self.n, self.n_clusters, replace=False)]
        a = None
        for _ in range(iters):
            d = ((x[:, None] - cent[None]) ** 2).sum(-1)
            a = np.argmin(d, axis=1)
            counts = np.bincount(a, minlength=self.n_clusters)[:, None]
            sums = np.zeros_like(cent)
            np.add.at(sums, a, x)
            new = sums / np.maximum(counts, 1).astype(np.float32)
            cent = np.where(counts > 0, new, cent).astype(np.float32)
        return cent, a

    def _probe_order(self, q: np.ndarray, fraction: float) -> List[int]:
        d = ((self.centroids - q[None]) ** 2).sum(axis=1)
        nprobe = max(1, int(round(self.nprobe * fraction)))
        return list(np.argsort(d)[:nprobe])

    def search(self, q: np.ndarray, k: int, fraction: float = 1.0) -> List[int]:
        out = []
        for st in self.staged_search(q, k, fraction):
            out = list(st.topk)
        return out

    def staged_search(self, q: np.ndarray, k: int,
                      fraction: float = 1.0) -> Iterator[SearchStage]:
        """One stage per probed cluster (closest centroid first)."""
        probe = self._probe_order(q, fraction)
        pool: List[Tuple[float, int]] = []
        scanned = 0
        for si, c in enumerate(probe):
            ids = self.lists[c]
            if len(ids):
                pool.extend(_l2_topk(q, self.vectors[ids], ids, k))
                pool.sort()
                pool = pool[:k]
            scanned += len(ids)
            sec = len(ids) * self.d * 4 / self.scan_bytes_per_s
            yield SearchStage(
                topk=tuple(d for _, d in pool),
                seconds=sec + 1e-4,
                fraction_searched=scanned / max(self.n, 1),
                is_final=(si == len(probe) - 1),
            )
