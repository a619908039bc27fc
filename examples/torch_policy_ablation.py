"""Replacement-policy ablation at paper scale through the PyTorch port's
discrete-event simulator (paper Fig. 17 / Table 2 shape): PGDSF vs GDSF vs LRU
vs LFU on an A10G + Mistral-7B profile with a drifting Zipf workload.  Host
code only: the simulator needs no device.

    PYTHONPATH=src python examples/torch_policy_ablation.py [--docs N] [--requests N]
"""

import argparse

from repro_torch.core.profiler import A10G_MISTRAL_7B
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.simulator import RAGSimulator, SimConfig

ap = argparse.ArgumentParser()
ap.add_argument("--docs", type=int, default=2000)
ap.add_argument("--requests", type=int, default=300)
args = ap.parse_args()

corpus = make_corpus(args.docs, mean_doc_tokens=1000, seed=0)
index = IVFIndex(corpus.doc_vectors, n_clusters=64, nprobe=8)
wl = make_workload(
    corpus, n_requests=args.requests, rate=0.8, zipf_s=1.0, drift=0.15, seed=2
)

print(f"{'policy':>8} {'hit rate':>9} {'avg TTFT':>9} {'p99':>7}")
for policy in ("pgdsf", "gdsf", "lru", "lfu"):
    cfg = SimConfig(
        profile=A10G_MISTRAL_7B,
        policy=policy,
        gpu_cache_bytes=int(0.25 * 2**30),
        host_cache_bytes=2 * 2**30,
        reorder=False,
        speculative=False,
    )
    m = RAGSimulator(cfg, corpus, index, wl).run()
    print(f"{policy:>8} {m.doc_hit_rate:>9.3f} {m.avg_ttft:>8.3f}s {m.p99_ttft:>6.2f}s")
print("\n(paper Fig.17: PGDSF highest hit rate, lowest TTFT)")
