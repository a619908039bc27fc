"""End-to-end RAG serving entry point of the port (counterpart of
``repro.launch.serve``): builds a corpus + vector index, instantiates a
model, and serves a Poisson workload through the continuous-batching
runtime (staged retrieval -> knowledge tree -> paged prefill -> paged
decode), printing TTFT/TPOT percentiles and cache statistics.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 12 --docs 50 --top-k 2 [--device cpu]

The CLI uses the reduced config; ``make_setup(args, cfg=...)`` takes the
full one.  ``--device`` defaults to ``cuda``.  Not ported yet (ROADMAP.md
Queue A): ``--sequential``, ``--check-tokens``, ``--frontdoor``, ``--tp``,
``--replicas`` > 1, ``--mode cag``, ``--reuse chunk`` and ``--attn dense``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_reduced
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.runtime import ContinuousRuntime, resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on ('cuda' or 'cpu')")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--docs", type=int, default=50)
    ap.add_argument("--doc-tokens", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--policy", default="pgdsf",
                    choices=["pgdsf", "gdsf", "lru", "lfu"])
    ap.add_argument("--gpu-cache-bytes", type=int, default=64 * 2**20,
                    help="knowledge-tree GPU tier budget (bytes); also sizes "
                         "the paged pool")
    ap.add_argument("--host-cache-bytes", type=int, default=512 * 2**20,
                    help="knowledge-tree host tier budget (bytes)")
    ap.add_argument("--disk-cache-bytes", type=int, default=0,
                    help="disk tier budget below host memory (0 = "
                         "disabled); demotion cascades GPU->host->disk")
    ap.add_argument("--disk-cache-dir", default=None,
                    help="directory for the disk tier's segment files "
                         "(default: a fresh temp dir)")
    ap.add_argument("--no-reorder", action="store_true")
    ap.add_argument("--no-spec", action="store_true")
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode-batch slots")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="tokens per prefill chunk (0 = unchunked)")
    ap.add_argument("--max-prefill-bs", type=int, default=4,
                    help="row slots of the ragged paged-prefill batch")
    ap.add_argument("--max-prefill-tokens", type=int, default=0,
                    help="ragged prefill-batch token budget per engine "
                         "iteration (0 = one request per iteration)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-KV block size in tokens")
    ap.add_argument("--attn", default="auto", choices=["paged", "auto"],
                    help="attention engine; 'auto' = paged (the CUDA "
                         "kernels on a CUDA device, plain PyTorch on CPU)")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--zipf-s", type=float, default=1.2,
                    help="Zipf doc-popularity skew of the workload")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="fraction of popularity ranks reshuffled per "
                         "workload phase (0 = stationary)")
    ap.add_argument("--n-phases", type=int, default=8,
                    help="workload phases for --drift")
    ap.add_argument("--output-len-mean", type=int, default=1,
                    help="mean decode length of the workload's requests")
    ap.add_argument("--search-scale", type=float, default=1.0,
                    help="scale staged-search stage durations")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def make_setup(args, cfg=None):
    """Build (cfg, params, corpus, idx, workload).  ``cfg`` defaults to the
    reduced config of ``--arch``; params are seeded random weights on
    ``--device``."""
    cfg = cfg if cfg is not None else get_reduced(args.arch)
    params = M.init_params(cfg, args.seed, resolve_device(args.device))
    corpus = make_corpus(args.docs, mean_doc_tokens=args.doc_tokens,
                         vocab=cfg.vocab_size, seed=args.seed)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=min(16, args.docs),
                   nprobe=8)
    wl = make_workload(corpus, n_requests=args.requests, rate=args.rate,
                       question_tokens=8, vocab=cfg.vocab_size,
                       zipf_s=args.zipf_s, seed=args.seed + 1,
                       drift=args.drift, n_phases=args.n_phases,
                       output_len_mean=args.output_len_mean)
    return cfg, params, corpus, idx, wl


def tier_hit_line(tree) -> str:
    s = tree.stats
    return (f"tier hits (tokens): gpu {s['hit_tokens_gpu']} / "
            f"host {s['hit_tokens_host']} / disk {s['hit_tokens_disk']}  "
            f"(spilled {s['spill_bytes']} B, fetched {s['fetch_bytes']} B)")


def serve_continuous(cfg, params, corpus, idx, wl, args, econf=None):
    """Serve ``wl`` through one continuous runtime; returns (results,
    runtime) so callers can read its metrics and tree."""
    econf = econf if econf is not None else EngineConfig.from_args(args)
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                           device=args.device)
    t0 = time.time()
    results = rt.serve(wl, max_new_tokens=args.max_new_tokens)
    wall = time.time() - t0
    print(f"\n[continuous] served {len(results)} requests in {wall:.1f}s "
          f"wall on {rt.device}")
    print(f"{'req':>4} {'docs':>12} {'alpha':>6} {'beta':>5} "
          f"{'ttft_ms':>8} {'spec':>5}  tokens")
    for r in results:
        print(f"{r.req_id:>4} {str(r.docs):>12} {r.alpha:>6} {r.beta:>5} "
              f"{r.ttft * 1000:>8.1f} {'hit' if r.speculative_hit else '':>5}"
              f"  {r.tokens}")
    print()
    print(rt.metrics.format_report())
    print(tier_hit_line(rt.tree))
    print(f"tree stats: {rt.tree.stats}")
    return results, rt


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    econf = EngineConfig.from_args(args)
    cfg, params, corpus, idx, wl = make_setup(args)
    print(f"model={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} device={args.device}")
    serve_continuous(cfg, params, corpus, idx, wl, args, econf=econf)


if __name__ == "__main__":
    main()
