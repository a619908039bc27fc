"""End-to-end RAG serving entry point of the port (counterpart of
``repro.launch.serve``): builds a corpus + vector index, instantiates a
model, and serves a Poisson workload through the continuous-batching
runtime (staged retrieval -> knowledge tree -> paged prefill -> paged
decode), printing TTFT/TPOT percentiles and cache statistics.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 12 --docs 50 --top-k 2 [--device cpu]

``--sequential`` serves through the one-request-at-a-time ``RAGServer``
instead, and ``--check-tokens [exact|tol:<eps>]`` runs BOTH and compares
their outputs: bare or ``exact``, greedy tokens must be identical;
``tol:<eps>``, tokens must match or the first-token logits agree within
L-inf <= eps.  ``--mode cag`` preloads the whole corpus KV into the disk
tier (auto-sized when ``--disk-cache-bytes`` is 0) and serves with zero
retrieval stages; ``--attn dense`` runs the dense-gather baseline.

The CLI uses the reduced config unless ``--full-size`` asks for the
published one; ``make_setup(args, cfg=...)`` takes any.  ``--device``
defaults to ``cuda``.  Not ported yet (ROADMAP.md Queue A):
``--frontdoor``, ``--tp``, ``--replicas`` > 1 and ``--reuse chunk``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import RAGServer
from repro_torch.serving.runtime import ContinuousRuntime, resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--full-size", action="store_true",
                    help="serve the published config of --arch (default: "
                         "its reduced test-size config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on ('cuda' or 'cpu')")
    ap.add_argument("--mode", default="rag", choices=["rag", "cag"],
                    help="'rag' runs staged retrieval per request; 'cag' "
                         "preloads the FULL corpus KV into the disk tier at "
                         "start-up and serves with zero retrieval stages")
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
    ap.add_argument("--attn", default="auto",
                    choices=["dense", "paged", "auto"],
                    help="continuous-mode attention engine for prefill and "
                         "decode: 'paged' computes straight against the "
                         "pool's pages (the CUDA kernels on a CUDA device, "
                         "plain PyTorch on CPU); 'dense' prefills through "
                         "the dense prefill over the gathered prefix and "
                         "decodes over a dense cache gathered every step "
                         "(A/B baseline); 'auto' = paged.  The sequential "
                         "engine is always dense")
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
    ap.add_argument("--sequential", action="store_true",
                    help="serve through the one-at-a-time RAGServer")
    ap.add_argument("--check-tokens", nargs="?", const="exact", default=None,
                    metavar="MODE",
                    help="run both engines and verify outputs.  Bare flag "
                         "or 'exact': greedy tokens must be identical.  "
                         "'tol:<eps>': tokens must match OR the first-token "
                         "logits must agree within L-inf <= eps")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def make_setup(args, cfg=None):
    """Build (cfg, params, corpus, idx, workload).  ``cfg`` defaults to the
    reduced config of ``--arch`` (the published one under ``--full-size``);
    params are seeded random weights on ``--device``."""
    if cfg is None:
        cfg = (get_config if args.full_size else get_reduced)(args.arch)
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


def parse_check_mode(value):
    """--check-tokens MODE -> ("exact", 0.0) or ("tol", eps).

    'exact' (or the bare flag) keeps the bit-identical contract; 'tol:<eps>'
    accepts token divergence when the first-token logits agree within
    L-inf <= eps."""
    if value is None or value == "exact":
        return "exact", 0.0
    if isinstance(value, str) and value.startswith("tol:"):
        try:
            eps = float(value[len("tol:"):])
        except ValueError:
            raise SystemExit(f"--check-tokens: bad tolerance {value!r}")
        if eps < 0 or not np.isfinite(eps):
            raise SystemExit(f"--check-tokens: tolerance must be a finite "
                             f"non-negative number, got {value!r}")
        return "tol", eps
    raise SystemExit(f"--check-tokens: unknown mode {value!r} "
                     f"(use 'exact' or 'tol:<eps>')")


def token_mismatches(pairs, mode, eps):
    """Compare (continuous, sequential) result pairs under a check mode.

    exact: greedy tokens must be bit-identical.  tol: tokens may diverge iff
    both sides carry first-token logits within L-inf <= eps.  Returns the
    offending (req_id, tokens_a, tokens_b[, linf]) tuples."""
    bad = []
    for a, b in pairs:
        if list(a.tokens) == list(b.tokens):
            continue
        if mode == "tol" and a.first_logits is not None \
                and b.first_logits is not None:
            linf = float(np.max(np.abs(
                np.asarray(a.first_logits, np.float64)
                - np.asarray(b.first_logits, np.float64))))
            if linf <= eps:
                continue
            bad.append((a.req_id, list(a.tokens), list(b.tokens), linf))
        else:
            bad.append((a.req_id, list(a.tokens), list(b.tokens)))
    return bad


def print_preload(engine) -> None:
    """One-line CAG corpus-preload summary."""
    ps = engine.preload_stats
    if ps:
        print(f"[cag] preloaded {ps['docs']} docs / {ps['tokens']} tokens "
              f"({ps['bytes']} B, {ps['files']} files) into the disk tier "
              f"in {ps['seconds']:.2f}s of disk writes")


def serve_sequential(cfg, params, corpus, idx, wl, args, econf=None):
    """Serve ``wl`` through the sequential RAGServer, the single-device
    token oracle; returns (results sorted by req_id, engine)."""
    econf = econf if econf is not None else EngineConfig.from_args(args)
    srv = RAGServer(cfg, params, corpus, idx, config=econf,
                    device=args.device)
    print_preload(srv)
    t0 = time.time()
    results = srv.serve(wl, max_new_tokens=args.max_new_tokens)
    wall = time.time() - t0
    results = sorted(results, key=lambda r: r.req_id)
    print(f"\n[sequential] served {len(results)} requests in {wall:.1f}s "
          f"wall on {srv.device}")
    print(f"{'req':>4} {'docs':>12} {'alpha':>6} {'beta':>5} "
          f"{'ttft_ms':>8}  tokens")
    for r in results:
        print(f"{r.req_id:>4} {str(r.docs):>12} {r.alpha:>6} {r.beta:>5} "
              f"{r.ttft * 1000:>8.1f}  {r.tokens}")
    ttfts = np.asarray([r.ttft for r in results])
    print(f"mean TTFT {ttfts.mean() * 1e3:.1f} ms  "
          f"(search+transfer+prefill summed serially)")
    print(f"doc hit rate: {srv.controller.doc_hit_rate:.2%}")
    print(tier_hit_line(srv.tree))
    print(f"tree stats: {srv.tree.stats}")
    return results, srv


def serve_continuous(cfg, params, corpus, idx, wl, args, econf=None):
    """Serve ``wl`` through one continuous runtime; returns (results,
    runtime) so callers can read its metrics and tree."""
    econf = econf if econf is not None else EngineConfig.from_args(args)
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                           device=args.device)
    print_preload(rt)
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
    if args.mode == "cag" and econf.disk_cache_bytes == 0:
        # auto-size the disk tier to hold the whole corpus KV exactly
        kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd
                    * cfg.tdtype.itemsize)
        need = int(corpus.doc_lengths.sum()) * kv_bytes
        econf = dataclasses.replace(econf, disk_cache_bytes=need)
        print(f"[cag] --disk-cache-bytes 0 -> auto-sized to {need} B "
              f"({len(corpus.doc_lengths)} docs, {kv_bytes} B/token)")
    if args.check_tokens:
        mode, eps = parse_check_mode(args.check_tokens)
        cont, _ = serve_continuous(cfg, params, corpus, idx, wl, args,
                                   econf=econf)
        seq, _ = serve_sequential(cfg, params, corpus, idx, wl, args,
                                  econf=econf)
        mismatches = token_mismatches(zip(cont, seq), mode, eps)
        if mismatches:
            raise SystemExit(f"token mismatch: {mismatches}")
        what = "identical" if mode == "exact" else f"within tol {eps:g}"
        print(f"\ntoken check: all {len(cont)} requests {what} "
              f"(continuous vs sequential)")
    elif args.sequential:
        serve_sequential(cfg, params, corpus, idx, wl, args, econf=econf)
    else:
        serve_continuous(cfg, params, corpus, idx, wl, args, econf=econf)


if __name__ == "__main__":
    main()
