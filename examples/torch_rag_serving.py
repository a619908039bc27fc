"""End-to-end RAG serving on the PyTorch port with the sequential engine:
staged IVF retrieval, speculative-pipelining decisions, knowledge-tree
caching, cache-aware reordering, prefix prefill and greedy decode; then an
ablation pass that re-serves the same workload without the cache, whose
answers must be the same.  On the card the prefills' attention is the prefix
kernel (``kernels/csrc/prefix_attention.cu``); on the CPU its plain version.

    PYTHONPATH=src python examples/torch_rag_serving.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.kernels import prefix_attention as PX
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import RAGServer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

cfg = get_reduced("qwen2-0.5b")
params = M.init_params(cfg, 0, device=args.device)
corpus = make_corpus(40, mean_doc_tokens=32, vocab=cfg.vocab_size, seed=0)
index = IVFIndex(corpus.doc_vectors, n_clusters=8, nprobe=4)
wl = make_workload(
    corpus,
    n_requests=10,
    rate=100.0,
    zipf_s=1.3,
    question_tokens=8,
    vocab=cfg.vocab_size,
    seed=1,
)

print("== RAGCache serving (PGDSF, reorder, speculative pipelining) ==")
srv = RAGServer(
    cfg, params, corpus, index, config=EngineConfig(top_k=2), device=args.device
)
res = srv.serve(wl, max_new_tokens=3)
hits = [r for r in res if r.alpha > 0]
print(
    f"hit rate: {srv.controller.doc_hit_rate:.0%} "
    f"({len(hits)}/{len(res)} requests had a prefix hit)"
)
if hits:
    cold = np.mean([r.prefill_time for r in res if r.alpha == 0])
    warm = np.mean([r.prefill_time for r in hits])
    print(
        f"mean prefill: cold={cold * 1000:.1f}ms warm={warm * 1000:.1f}ms "
        f"({cold / warm:.1f}x)"
    )

print("\n== same workload, cache disabled (vLLM-like baseline) ==")
no_cache = EngineConfig(
    top_k=2,
    gpu_cache_bytes=0,
    host_cache_bytes=0,
    reorder=False,
    speculative=False,
)
base = RAGServer(cfg, params, corpus, index, config=no_cache, device=args.device)
res_b = base.serve(wl, max_new_tokens=3)
print(f"hit rate: {base.controller.doc_hit_rate:.0%}")

# answers must be identical with and without caching
by_id = {r.req_id: r.tokens for r in res_b}
same = sum(r.tokens == by_id[r.req_id] for r in res)
print(f"\nidentical answers with/without cache: {same}/{len(res)}")
print(
    f"device {srv.device}: prefix kernel launches "
    f"{PX.prefix_flash_attention.launches}, plain version calls "
    f"{PX.prefix_attention_torch.calls}"
)
assert same == len(res)
print("OK")
