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

``--reuse chunk`` caches each doc once and reuses it at any position,
recomputing the first ``--recompute-tokens`` rows of each relocated doc;
relocated reuse is approximate, so check it with ``--check-tokens
tol:<eps>``.

``--replicas N`` serves through N continuous runtimes behind a
``ReplicaRouter`` (doc affinity by default, ``--routing`` picks another
policy).  On one card the N runtimes share the device and one set of
weights, each with its own pool and knowledge tree.  Routing never changes
computation, so ``--check-tokens`` holds at any replica count.

``--frontdoor`` puts the front-door layer ahead of the router: a query
cache (exact and cosine-similarity hits, TTL and LRU bounded), per-tenant
SLO admission (degrade top-k, then shed) and, with ``--autoscale``, a
fleet autoscaler over [--autoscale-min, --replicas] that warms a joining
replica from its disk tier.  ``--tenants N`` draws the workload from the
multi-tenant traffic model (retrieval/traffic.py).  With ``--frontdoor``,
``--check-tokens`` compares only the admitted misses; hits are answered
from the cache and shed requests never run.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        [--reuse chunk --check-tokens tol:0.05] \
        [--replicas 2 --routing {affinity,round_robin,least_loaded}] \
        [--frontdoor --tenants 3 --replicas 2 --autoscale]

The CLI uses the reduced config unless ``--full-size`` asks for the
published one; ``make_setup(args, cfg=...)`` takes any.  ``--arch`` takes
``qwen2-0.5b`` (the default), ``mistral-7b`` and ``llama2-7b``, the paper's
evaluation models, the rest of the dense family (``gemma3-12b``, head dim
256; ``gemma2-27b``, softcaps; ``yi-34b``, R 7; ``llama2-70b``),
``mixtral-8x7b`` and ``phi3.5-moe-42b-a6.6b`` (MoE),
``internvl2-1b`` (VLM: its text backbone is served), and the recurrent
families ``xlstm-1.3b`` (ssm) and ``hymba-1.5b`` (hybrid), which always go
to the sequential engine, caching each document's state snapshot
(``--check-tokens``, ``--frontdoor``, ``--replicas`` and ``--tp`` apply to
the continuous engine only, and say so).  ``musicgen-large`` (audio) is
registered but served by neither engine: its model steps take codebook
tokens (B, K, S), and the engines raise ``ValueError`` on its (B, S)
requests, as the reference's do.  At full size the
seeded random bf16 weights take 14.5 GB (Mistral-7B), 13.5 GB
(LLaMA2-7B), 23.5 GB (Gemma3-12B), 54.5 GB (Gemma2-27B) and 68.8 GB
(Yi-34B) on the card; LLaMA2-70B's (138.0 GB), Mixtral-8x7B's (93.4 GB)
and Phi-3.5-MoE's (83.7 GB) do not fit one 80 GB card, and ``--full-size``
refuses them before drawing any weight.  Under ``--tp N`` (without
``--check-tokens`` or ``--sequential``, whose one-device oracle needs the
whole tree) each leaf is split over the cards as it is drawn, and the
check is the first card's peak during that draw
(``launch/sharding.py::card_bytes``: its split weights / N, the whole
wo/wd and norms, and the leaf in flight): LLaMA2-70B at ``--tp 4``
peaks at 72.6 GB (70.7 GB held after the draw) and passes, and then
needs four visible cards; no run of it on four cards exists.
``--gpu-cache-bytes`` sizes
the paged pool, clipped at 4096 blocks: keep it at or below 4096 blocks
of KV (7.875 GiB for Mistral-7B, 31.5 GiB for LLaMA2-7B at block 16), or
the knowledge tree budgets GPU space the pool lacks.

    PYTHONPATH=src python -m repro_torch.launch.serve --full-size \
        --arch mistral-7b --gpu-cache-bytes 8053063680 --check-tokens tol:0.3

``--tp N`` serves each replica over a ``(1, N)`` mesh, as the
reference's does: the one-line ``SystemExit`` when N does not divide both
head counts comes before any device work, then the mesh (the cards
``cuda:0 .. N-1``; N CPU shards with ``--device cpu``) and the chosen
partition specs are printed.  Params shard over the mesh, the pool's
planes shard whole KV heads, and the tokens, tier hits and first-token
logits are tp 1's bit for bit, so ``--check-tokens`` holds;
``--replicas R --tp N`` is the 2D fleet, each replica with its own mesh
over the same first N devices.  The MoE family serves under ``--tp`` too
(``--arch mixtral-8x7b --tp 2 --check-tokens``): its expert stacks split
along E when N divides it, else along d_ff (the printed specs say which).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --tp 2 --check-tokens

``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.sharding import (assert_tp_compatible, card_bytes,
                                         placer, spec_summary, split_shards,
                                         trivial)
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.traffic import make_default_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import (EngineConfig, FleetConfig,
                                        FrontDoorConfig)
from repro_torch.serving.engine import RAGServer
from repro_torch.serving.frontdoor import (TenantSLO, attach_answers,
                                           frontdoor_partition,
                                           make_frontdoor)
from repro_torch.serving.metrics import FleetMetrics
from repro_torch.serving.router import (ROUTING_POLICIES, ReplicaRouter,
                                        partition_requests)
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="independent continuous-runtime replicas behind "
                         "the doc-affinity router (each owns its own "
                         "knowledge tree / paged pool / scheduler; on one "
                         "card they share the device and the weights)")
    ap.add_argument("--routing", default="affinity",
                    choices=list(ROUTING_POLICIES),
                    help="replica routing policy (routing never changes "
                         "computation, so --check-tokens holds at any "
                         "replica count)")
    ap.add_argument("--max-queue-skew", type=int, default=4,
                    help="affinity escape hatch: max allowed max-min "
                         "per-replica queue-depth skew before a request "
                         "escapes to the least-loaded replica")
    ap.add_argument("--max-shadow-paths", type=int, default=4096,
                    help="bound on the router's shadow ledger of "
                         "per-replica routed doc-set paths (affinity "
                         "routing state, evicted LRU)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="tokens per prefill chunk (0 = unchunked)")
    ap.add_argument("--max-prefill-bs", type=int, default=4,
                    help="row slots of the ragged paged-prefill batch")
    ap.add_argument("--max-prefill-tokens", type=int, default=0,
                    help="ragged prefill-batch token budget per engine "
                         "iteration (0 = one request per iteration)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-KV block size in tokens")
    ap.add_argument("--reuse", default="prefix",
                    choices=["prefix", "chunk"],
                    help="KV-reuse discipline: 'prefix' reuses the longest "
                         "cached doc-sequence prefix (bit-identical); "
                         "'chunk' caches each doc ONCE and reuses it at any "
                         "position, recomputing --recompute-tokens boundary "
                         "rows per relocated chunk (approximate — verify "
                         "with --check-tokens tol:<eps>; requires the paged "
                         "engine).  The sequential engine ignores this (it "
                         "stays the exact oracle)")
    ap.add_argument("--recompute-tokens", type=int, default=16,
                    help="boundary tokens recomputed per relocated chunk "
                         "(--reuse chunk); rounds UP to the block size so "
                         "the reused tail stays page-aligned, and clamps "
                         "to the chunk length (>= doc length degenerates "
                         "to an exact full recompute)")
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
    # multi-tenant traffic model (retrieval/traffic.py)
    ap.add_argument("--tenants", type=int, default=0,
                    help="generate the workload from N tenants with "
                         "per-tenant Zipf skew, canonical query pools "
                         "(repeats -> front-door hits) and SLOs "
                         "(0 = single-tenant make_workload)")
    ap.add_argument("--slo-ttft-ms", type=float, default=500.0,
                    help="base per-tenant TTFT SLO target (tenant i gets "
                         "base * (1 + 0.5 i)); also the default SLO for "
                         "single-tenant --frontdoor runs")
    ap.add_argument("--tenant-queries", type=int, default=16,
                    help="canonical query pool size per tenant (smaller = "
                         "more repeats = higher front-door hit rate)")
    ap.add_argument("--diurnal-amplitude", type=float, default=0.0,
                    help="sinusoidal arrival-rate modulation depth (0..1)")
    ap.add_argument("--burst-rate-mult", type=float, default=1.0,
                    help="Markov-modulated burst-state rate multiplier "
                         "(1 = bursts off)")
    # front-door request layer (serving/frontdoor.py)
    ap.add_argument("--frontdoor", action="store_true",
                    help="serve through the front-door layer: query-level "
                         "cache (exact + similarity) -> per-tenant SLO "
                         "admission -> autoscaler -> replica router; "
                         "cache hits never reach an engine")
    ap.add_argument("--frontdoor-ttl", type=float, default=60.0,
                    help="query-cache TTL in seconds (entries expire TTL "
                         "after insertion regardless of use)")
    ap.add_argument("--frontdoor-sim-threshold", type=float, default=0.98,
                    help="cosine threshold for similarity hits against "
                         "cached query vectors (>= 1.0 disables the "
                         "similarity probe)")
    ap.add_argument("--frontdoor-capacity", type=int, default=512,
                    help="query-cache LRU capacity bound (entries)")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable the fleet autoscaler: replicas in "
                         "[--autoscale-min, --replicas] against backlog "
                         "signals; scale-ups warm the joining replica's "
                         "tree from its disk tier")
    ap.add_argument("--autoscale-min", type=int, default=1,
                    help="autoscaler floor (active replicas never below)")
    ap.add_argument("--scale-up-backlog", type=float, default=8.0,
                    help="backlog per active replica above which the "
                         "fleet grows")
    ap.add_argument("--scale-down-backlog", type=float, default=2.0,
                    help="backlog per active replica below which the "
                         "fleet shrinks")
    ap.add_argument("--autoscale-cooldown", type=float, default=2.0,
                    help="seconds between autoscale events")
    ap.add_argument("--search-scale", type=float, default=1.0,
                    help="scale staged-search stage durations")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree per replica: a (1, tp) "
                         "mesh of devices (the first tp cards, or tp CPU "
                         "shards with --device cpu)")
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


# device memory of the one card the port serves a model on (an H100)
ONE_CARD_BYTES = 80e9


def make_setup(args, cfg=None, mesh=None):
    """Build (cfg, params, corpus, idx, workload, tenants).  ``cfg``
    defaults to the reduced config of ``--arch`` (the published one under
    ``--full-size``, which raises ``ValueError`` for a model whose weights
    on its first card pass 80 GB); params are seeded random weights on
    ``--device``, or, given a tensor-parallel ``mesh``, the per-shard trees
    over it, each leaf split as it is drawn (``init_params(place=)``), so
    no card ever holds the whole tree.  ``tenants`` is the TenantSpec
    list when --tenants > 0 (multi-tenant traffic model), else None
    (single-tenant make_workload)."""
    if cfg is None:
        cfg = (get_config if args.full_size else get_reduced)(args.arch)
        tp = max(1, getattr(args, "tp", 1))
        if args.full_size and tp == 1:
            need = cfg.n_params() * cfg.tdtype.itemsize
            if need > ONE_CARD_BYTES:
                raise ValueError(
                    f"--full-size --arch {args.arch}: {need / 1e9:.1f} GB "
                    f"of {cfg.dtype} weights do not fit one 80 GB card; "
                    f"serving it needs tensor parallelism (--tp N over N "
                    f"cards)")
        elif args.full_size:
            need = card_bytes(cfg, tp)
            if need > ONE_CARD_BYTES:
                raise ValueError(
                    f"--full-size --arch {args.arch} --tp {tp}: "
                    f"{need / 1e9:.1f} GB of {cfg.dtype} weights on the "
                    f"first card (the split ones / {tp} plus the whole "
                    f"wo/wd, expert wd and norms) do not fit one 80 GB "
                    f"card")
    if not trivial(mesh):
        params = split_shards(
            M.init_params(cfg, args.seed, mesh.controller,
                          place=placer(cfg, mesh)), mesh.shape["model"])
    else:
        params = M.init_params(cfg, args.seed, resolve_device(args.device))
    return (cfg, params) + make_data(args, cfg)


def make_data(args, cfg):
    """Build (corpus, idx, workload, tenants) from the flags, for the
    vocabulary of ``cfg``: everything ``make_setup`` builds but the
    weights."""
    corpus = make_corpus(args.docs, mean_doc_tokens=args.doc_tokens,
                         vocab=cfg.vocab_size, seed=args.seed)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=min(16, args.docs),
                   nprobe=8)
    if args.tenants > 0:
        tenants, wl = make_default_workload(
            corpus, n_tenants=args.tenants, n_requests=args.requests,
            rate=args.rate, slo_ttft_ms=args.slo_ttft_ms,
            zipf_s=args.zipf_s, n_queries=args.tenant_queries,
            seed=args.seed + 1, drift=args.drift, n_phases=args.n_phases,
            diurnal_amplitude=args.diurnal_amplitude,
            burst_rate_mult=args.burst_rate_mult, vocab=cfg.vocab_size,
            question_tokens=8, output_len_mean=args.output_len_mean)
        return corpus, idx, wl, tenants
    wl = make_workload(corpus, n_requests=args.requests, rate=args.rate,
                       question_tokens=8, vocab=cfg.vocab_size,
                       zipf_s=args.zipf_s, seed=args.seed + 1,
                       drift=args.drift, n_phases=args.n_phases,
                       output_len_mean=args.output_len_mean)
    return corpus, idx, wl, None


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


def print_preload(engine, n_replicas: int = 1) -> None:
    """One-line CAG corpus-preload summary."""
    ps = engine.preload_stats
    if ps:
        per = f" per replica x{n_replicas}" if n_replicas > 1 else ""
        print(f"[cag] preloaded {ps['docs']} docs / {ps['tokens']} tokens "
              f"({ps['bytes']} B, {ps['files']} files) into the disk tier "
              f"in {ps['seconds']:.2f}s of disk writes{per}")


def serve_sequential(cfg, params, corpus, idx, wl, args, econf=None,
                     slabs: int = 1):
    """Serve ``wl`` through the sequential RAGServer, the single-device
    token oracle, over a one-device mesh of ``slabs`` column slabs (a
    tensor-parallel serve's group, whose bits it then computes); returns
    (results sorted by req_id, engine)."""
    econf = econf if econf is not None else EngineConfig.from_args(args)
    mesh = (make_serving_mesh(1, device=args.device, slabs=slabs)
            if slabs > 1 else None)
    srv = RAGServer(cfg, params, corpus, idx, config=econf,
                    device=args.device, mesh=mesh)
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


def make_runtimes(cfg, params, corpus, idx, args, n, econf=None):
    """N continuous runtimes on ``--device``: each owns its pool, tree and
    scheduler; all read the one ``params`` dict, or the one list of
    per-shard trees (no copy per replica)."""
    econf = econf if econf is not None else EngineConfig.from_args(args)
    return [ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                              device=args.device)
            for _ in range(n)]


def fleet_inputs(corpus, idx, args, n, top_k_of=None):
    """The router's view of a request: its retrieved docs (deterministic,
    equal to the runtime's final staged-search result), their token
    counts, its context length, and the in-flight window modelling each
    replica's backlog draining while the trace arrives."""
    top_k_of = top_k_of or (lambda r: args.top_k)
    return dict(
        docs_of=lambda r: idx.search(r.query_vec, top_k_of(r)),
        doc_tokens_of=lambda docs: [int(corpus.doc_lengths[d])
                                    for d in docs],
        context_of=lambda r, docs, toks: sum(toks) + len(r.question_tokens),
        window=2 * args.max_batch * n)


def serve_shares(rts, shares, args):
    """Serve each replica's share in turn; returns (results sorted by
    req_id, wall seconds)."""
    t0 = time.time()
    results = []
    for rt, share in zip(rts, shares):
        if share:
            results.extend(rt.serve(share,
                                    max_new_tokens=args.max_new_tokens))
    wall = time.time() - t0
    results.sort(key=lambda r: r.req_id)
    return results, wall


def serve_continuous(cfg, params, corpus, idx, wl, args, econf=None,
                     fleet_conf=None):
    """Serve ``wl`` through ``--replicas`` continuous runtimes behind the
    router; returns (results sorted by req_id, runtimes) so callers can
    read each runtime's metrics and tree."""
    n = max(1, args.replicas)
    fleet_conf = (fleet_conf if fleet_conf is not None
                  else FleetConfig.from_args(args))
    rts = make_runtimes(cfg, params, corpus, idx, args, n, econf=econf)
    print_preload(rts[0], n)
    router = ReplicaRouter(rts, config=fleet_conf)
    shares = partition_requests(router, wl,
                                **fleet_inputs(corpus, idx, args, n))
    results, wall = serve_shares(rts, shares, args)
    label = "continuous" if n == 1 else f"continuous x{n} ({args.routing})"
    print(f"\n[{label}] served {len(results)} requests in {wall:.1f}s "
          f"wall on {rts[0].device}")
    print(f"{'req':>4} {'docs':>12} {'alpha':>6} {'beta':>5} "
          f"{'ttft_ms':>8} {'spec':>5}  tokens")
    for r in results:
        print(f"{r.req_id:>4} {str(r.docs):>12} {r.alpha:>6} {r.beta:>5} "
              f"{r.ttft * 1000:>8.1f} {'hit' if r.speculative_hit else '':>5}"
              f"  {r.tokens}")
    print()
    if n == 1:
        print(rts[0].metrics.format_report())
        print(tier_hit_line(rts[0].tree))
        print(f"tree stats: {rts[0].tree.stats}")
    else:
        fleet = FleetMetrics(router.stats())
        for i, rt in enumerate(rts):
            fleet.add_replica(f"replica{i}", rt.metrics)
        print(fleet.format_report())
        for i, rt in enumerate(rts):
            print(f"replica{i} {tier_hit_line(rt.tree)}")
    return results, rts


def build_frontdoor(args, tenants, fdc=None):
    """Assemble the FrontDoor policy stack from CLI flags (via
    FrontDoorConfig) through ``make_frontdoor``."""
    fdc = fdc if fdc is not None else FrontDoorConfig.from_args(args)
    slos = {}
    if tenants:
        slos = {t.name: TenantSLO(ttft_target=t.slo_ttft_ms / 1e3,
                                  min_top_k=t.min_top_k) for t in tenants}
    n = max(1, args.replicas)
    return make_frontdoor(
        capacity=fdc.capacity, ttl=fdc.ttl,
        sim_threshold=fdc.sim_threshold, slos=slos,
        default_slo_ttft=fdc.slo_ttft_ms / 1e3, top_k=args.top_k,
        min_replicas=min(max(1, fdc.autoscale_min), n), max_replicas=n,
        autoscale=fdc.autoscale,
        scale_up_backlog=fdc.scale_up_backlog,
        scale_down_backlog=fdc.scale_down_backlog,
        cooldown=fdc.cooldown)


def serve_frontdoor(cfg, params, corpus, idx, wl, tenants, args, econf=None,
                    fleet_conf=None, fdc=None):
    """Serve through front door -> router -> N continuous runtimes.

    Returns (miss_results, part): engine results for admitted misses (the
    --check-tokens comparison set; hits are served from cache and shed
    requests never execute, so both are excluded by construction)."""
    n = max(1, args.replicas)
    fleet_conf = (fleet_conf if fleet_conf is not None
                  else FleetConfig.from_args(args))
    rts = make_runtimes(cfg, params, corpus, idx, args, n, econf=econf)
    print_preload(rts[0], n)
    router = ReplicaRouter(rts, config=fleet_conf)
    fd = build_frontdoor(args, tenants, fdc=fdc)
    part = frontdoor_partition(
        fd, router, wl, **fleet_inputs(
            corpus, idx, args, n,
            top_k_of=lambda r: r.top_k if r.top_k > 0 else args.top_k))
    results, wall = serve_shares(rts, part.shares, args)
    # answers only exist after serving: fill the cache entries (hits share
    # the entry object, so the cached answer reaches them too)
    attach_answers(part, {r.req_id: r.tokens for r in results})
    label = f"frontdoor x{n} ({args.routing})"
    print(f"\n[{label}] {len(wl)} requests -> {len(part.hits)} cache hits, "
          f"{len(part.shed)} shed, {len(results)} engine-served in "
          f"{wall:.1f}s wall on {rts[0].device}")
    for r, dec in part.hits:
        src = dec.entry.answer if dec.entry is not None else []
        print(f"{r.req_id:>4} {dec.kind:<11} <- req {dec.entry.source_req_id}"
              f"  tokens {src}")
    fleet = FleetMetrics(router.stats(), fd.stats())
    for i, rt in enumerate(rts):
        fleet.add_replica(f"replica{i}", rt.metrics)
    print(fleet.format_report())
    for i, b in sorted(part.warmed.items()):
        print(f"scale-up warmed replica{i}: {b} B from disk tier")
    return results, part


def check_line(what, n, mode, eps, note=""):
    how = "identical" if mode == "exact" else f"within tol {eps:g}"
    print(f"\ntoken check: all {n} {what} {how} (continuous vs "
          f"sequential{note})")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # the config dataclasses are built once from argparse here and threaded
    # through every constructor below — config= is the sole constructor API
    econf = EngineConfig.from_args(args)
    fleet_conf = FleetConfig.from_args(args)
    fdc = FrontDoorConfig.from_args(args)
    tp = econf.mesh.tp
    smesh = None
    family = get_reduced(args.arch).family
    if tp > 1:
        # head divisibility BEFORE any device work or device-count check,
        # so a bad --arch/--tp pair fails the same on any machine
        try:
            assert_tp_compatible(get_reduced(args.arch), tp)
        except ValueError as e:
            raise SystemExit(f"--tp {tp}: {e}")
        try:
            smesh = make_serving_mesh(tp, device=args.device)
        except ValueError as e:     # too few cards: a clean one-liner
            raise SystemExit(str(e))
    # the continuous engine's shards are drawn split over the mesh, unless
    # a one-device oracle (the sequential engine) needs the whole tree
    split = (smesh is not None and family in ("dense", "moe", "vlm")
             and not args.sequential
             and not args.check_tokens)
    cfg, params, corpus, idx, wl, tenants = make_setup(
        args, mesh=smesh if split else None)
    print(f"model={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} device={args.device}")
    if smesh is not None:
        print(f"tensor parallel: tp={tp} over a (1, {tp}) mesh "
              f"({', '.join(map(str, smesh.devices))})")
        print(spec_summary(cfg, smesh, M.init_params(cfg, 0, "meta")))
    if args.mode == "cag" and econf.disk_cache_bytes == 0 \
            and cfg.family not in M.RECURRENT:
        # auto-size the disk tier to hold the whole corpus KV exactly
        kv_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd
                    * cfg.tdtype.itemsize)
        need = int(corpus.doc_lengths.sum()) * kv_bytes
        econf = dataclasses.replace(econf, disk_cache_bytes=need)
        print(f"[cag] --disk-cache-bytes 0 -> auto-sized to {need} B "
              f"({len(corpus.doc_lengths)} docs, {kv_bytes} B/token)")
    recurrent = cfg.family in M.RECURRENT
    if recurrent and not args.sequential:
        print("note: recurrent-state family -> sequential engine")
    if args.replicas > 1 and (recurrent or args.sequential):
        print("note: --replicas applies to the continuous engine only; "
              "the sequential A/B side stays a single engine")
    if recurrent and args.check_tokens:
        print("note: --check-tokens unavailable for recurrent families "
              "(no continuous engine to compare against); NOT checked")
    if args.frontdoor and (recurrent or args.sequential):
        print("note: --frontdoor requires the continuous engine; ignored")
    if econf.mesh.tp > 1 and (recurrent or args.sequential):
        print("note: --tp applies to the continuous engine only; the "
              "sequential engine is the single-device token oracle")
    mode, eps = parse_check_mode(args.check_tokens)
    if args.frontdoor and not recurrent and not args.sequential:
        miss_results, part = serve_frontdoor(cfg, params, corpus, idx, wl,
                                             tenants, args, econf=econf,
                                             fleet_conf=fleet_conf, fdc=fdc)
        if args.check_tokens:
            # compare only admitted misses (the requests an engine actually
            # served, with the front door's top_k rewrites applied); hits
            # are answered from cache and shed requests never execute
            seq, _ = serve_sequential(cfg, params, corpus, idx,
                                      list(part.misses), args, econf=econf,
                                      slabs=tp)
            seq_by_id = {r.req_id: r for r in seq}
            mismatches = token_mismatches(
                [(a, seq_by_id[a.req_id]) for a in miss_results], mode, eps)
            if mismatches:
                raise SystemExit(f"token mismatch: {mismatches}")
            check_line("front-door miss requests", len(miss_results), mode,
                       eps, f"; {len(part.hits)} hits + {len(part.shed)} "
                            f"shed excluded by construction")
        return
    if args.check_tokens and not recurrent:
        cont, _ = serve_continuous(cfg, params, corpus, idx, wl, args,
                                   econf=econf, fleet_conf=fleet_conf)
        seq, _ = serve_sequential(cfg, params, corpus, idx, wl, args,
                                  econf=econf, slabs=tp)
        mismatches = token_mismatches(zip(cont, seq), mode, eps)
        if mismatches:
            raise SystemExit(f"token mismatch: {mismatches}")
        check_line("requests", len(cont), mode, eps)
    elif args.sequential or recurrent:
        serve_sequential(cfg, params, corpus, idx, wl, args, econf=econf)
    else:
        serve_continuous(cfg, params, corpus, idx, wl, args, econf=econf,
                         fleet_conf=fleet_conf)


if __name__ == "__main__":
    main()
