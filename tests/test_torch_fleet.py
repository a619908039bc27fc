"""The port's fleet layer against the JAX package's, on the CPU in f32: the
multi-tenant traffic model, the replica router, N runtimes behind it, and
the front door.

``retrieval/traffic.py``, ``serving/router.py`` and
``serving/frontdoor.py`` are copies of the JAX package's modules; these
tests drive each copy beside its original over the frameworks' own
runtimes and require the same requests, shares, tokens and partitions.
Params cross through ``params_from_numpy``, the port's index takes the
JAX index's clusters, and first-token logits must agree within 1e-4.
"""
import argparse
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.retrieval.corpus import make_corpus as jax_corpus
from repro.retrieval.traffic import make_default_workload as jax_default_wl
from repro.retrieval.vectordb import IVFIndex as JaxIVF
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import FleetConfig as JaxFleetConfig
from repro.serving.frontdoor import frontdoor_partition as jax_fd_partition
from repro.serving.router import ReplicaRouter as JaxRouter
from repro.serving.router import partition_requests as jax_partition
from repro.serving.runtime import ContinuousRuntime as JaxRuntime
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus
from repro_torch.retrieval.traffic import make_default_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig, FleetConfig
from repro_torch.serving.frontdoor import frontdoor_partition
from repro_torch.serving.router import ReplicaRouter, partition_requests
from repro_torch.serving.runtime import ContinuousRuntime
# both runtimes on one constant clock for the module (test_torch_clock.py)
from test_torch_clock import constant_clock  # noqa: F401

EPS = 1e-4
N_DOCS, NEW = 16, 3
# the flags both serve.py parsers share, at test size
ARGV = ["--docs", str(N_DOCS), "--doc-tokens", "24", "--requests", "24",
        "--max-new-tokens", str(NEW), "--max-batch", "2", "--replicas", "2",
        "--tenants", "3", "--tenant-queries", "4", "--rate", "40",
        "--autoscale", "--scale-up-backlog", "1", "--scale-down-backlog",
        "0.5", "--autoscale-cooldown", "0.05", "--slo-ttft-ms", "100"]


def _args(parser, *extra):
    return parser.parse_args(ARGV + list(extra))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_reduced("qwen2-0.5b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    params = M.params_from_numpy(flat, cfg)
    jcorpus = jax_corpus(N_DOCS, mean_doc_tokens=24, vocab=cfg.vocab_size,
                         seed=0)
    corpus = make_corpus(N_DOCS, mean_doc_tokens=24, vocab=cfg.vocab_size,
                         seed=0)
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=4, nprobe=4)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=4, nprobe=4)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    jargs = _args(jax_serve.build_parser())
    args = _args(serve.build_parser(), "--device", "cpu")
    kw = dict(n_tenants=3, n_requests=24, rate=40.0, slo_ttft_ms=100.0,
              zipf_s=1.2, n_queries=4, seed=1, vocab=cfg.vocab_size,
              question_tokens=8)
    jten, jwl = jax_default_wl(jcorpus, **kw)
    ten, wl = make_default_workload(corpus, **kw)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, params=params, jcorpus=jcorpus,
                corpus=corpus, jidx=jidx, idx=idx, jargs=jargs, args=args,
                jten=jten, ten=ten, jwl=jwl, wl=wl)


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _fleet(s, n, **conf):
    """n fresh runtimes a side, the same engine config on both."""
    conf = dict(dict(top_k=2, max_batch=2), **conf)
    jrts = [JaxRuntime(s["jcfg"], s["jp"], s["jcorpus"], s["jidx"],
                       config=JaxEngineConfig(**conf)) for _ in range(n)]
    rts = [ContinuousRuntime(s["cfg"], s["params"], s["corpus"], s["idx"],
                             config=EngineConfig(**conf), device="cpu")
           for _ in range(n)]
    return jrts, rts


def _inputs(corpus, idx, n):
    return dict(docs_of=lambda r: idx.search(r.query_vec, r.top_k or 2),
                doc_tokens_of=lambda d: [int(corpus.doc_lengths[i])
                                         for i in d],
                context_of=lambda r, d, t: sum(t) + len(r.question_tokens),
                window=4 * n)


def _ids(share):
    return [(r.req_id, r.top_k) for r in share]


def test_default_workload_matches_jax(setup):
    s = setup
    assert [dataclasses.asdict(t) for t in s["ten"]] == \
        [dataclasses.asdict(t) for t in s["jten"]]
    assert len(s["wl"]) == len(s["jwl"]) == 24
    for a, b in zip(s["wl"], s["jwl"]):
        assert (a.req_id, a.arrival, a.tenant, a.top_k) == \
            (b.req_id, b.arrival, b.tenant, b.top_k)
        assert np.array_equal(a.question_tokens, b.question_tokens)
        assert np.array_equal(a.query_vec, b.query_vec)
    assert len({r.tenant for r in s["wl"]}) == 3


@pytest.mark.parametrize("routing", ["affinity", "round_robin",
                                     "least_loaded"])
def test_partition_requests_matches_jax(setup, routing):
    s = setup
    jrts, rts = _fleet(s, 3)
    jrouter = JaxRouter(jrts, config=JaxFleetConfig(replicas=3,
                                                    routing=routing))
    router = ReplicaRouter(rts, config=FleetConfig(replicas=3,
                                                   routing=routing))
    want = jax_partition(jrouter, s["jwl"],
                         **_inputs(s["jcorpus"], s["jidx"], 3))
    got = partition_requests(router, s["wl"],
                             **_inputs(s["corpus"], s["idx"], 3))
    assert [_ids(x) for x in got] == [_ids(x) for x in want]
    assert router.stats() == jrouter.stats()
    assert sum(map(len, got)) == len(s["wl"])


def test_replicas_match_jax_and_one_replica(setup):
    """--replicas 2 through serve_continuous: the JAX package's tokens, and
    the port's own --replicas 1 tokens, bit for bit."""
    s = setup
    jwl, wl = s["jwl"][:10], s["wl"][:10]
    want = _quiet(jax_serve.serve_continuous, s["jcfg"], s["jp"],
                  s["jcorpus"], s["jidx"], jwl, s["jargs"])
    got, rts = _quiet(serve.serve_continuous, s["cfg"], s["params"],
                      s["corpus"], s["idx"], wl, s["args"])
    assert len(rts) == 2 and all(r.params[0] is s["params"] for r in rts)
    assert all(rt.store.pool.n_blocks > 0 for rt in rts)
    assert rts[0].store.k_planes[0].data_ptr() != \
        rts[1].store.k_planes[0].data_ptr()
    one_args = argparse.Namespace(**{**vars(s["args"]), "replicas": 1})
    one, _ = _quiet(serve.serve_continuous, s["cfg"], s["params"],
                    s["corpus"], s["idx"], wl, one_args)
    assert [r.req_id for r in got] == [r.req_id for r in want] \
        == [r.req_id for r in one]
    for a, b, c in zip(got, want, one):
        assert a.docs == b.docs == c.docs
        assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)
        assert a.tokens == c.tokens, (a.req_id, a.tokens, c.tokens)
        assert np.array_equal(a.first_logits, c.first_logits)
        linf = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                   - np.asarray(b.first_logits,
                                                np.float64))))
        assert linf <= EPS, (a.req_id, linf)
    for rt in rts:
        live = rt.store.pool.n_blocks - rt.store.pool.free_blocks
        tree = sum(len(n.payload_gpu.blocks) for n in rt.tree.nodes()
                   if n.in_gpu and n.payload_gpu is not None)
        assert live == tree + 1


def test_frontdoor_partition_matches_jax(setup):
    """The front door over a fleet whose second replica holds disk-resident
    KV: the same hits, shed, misses and warmed bytes on both sides."""
    s = setup
    # no speculation, one request at a time: the tiers' contents then do
    # not depend on measured wall times
    jrts, rts = _fleet(s, 2, gpu_cache_bytes=1 << 18,
                       host_cache_bytes=1 << 17, disk_cache_bytes=1 << 24,
                       speculative=False)
    # fill the joining replica's tiers so its warm-up reads from disk
    for jr, r in zip(s["jwl"][:6], s["wl"][:6]):
        jrts[1].serve([jr], max_new_tokens=1)
        rts[1].serve([r], max_new_tokens=1)
    assert rts[1].tree.stats["spill_bytes"] > 0
    counts = [{k: v for k, v in rt.tree.stats.items()
               if not k.endswith("seconds")} for rt in (rts[1], jrts[1])]
    assert counts[0] == counts[1]
    want = jax_fd_partition(
        jax_serve.build_frontdoor(s["jargs"], s["jten"]),
        JaxRouter(jrts, config=JaxFleetConfig(replicas=2)), s["jwl"],
        **_inputs(s["jcorpus"], s["jidx"], 2))
    got = frontdoor_partition(
        serve.build_frontdoor(s["args"], s["ten"]),
        ReplicaRouter(rts, config=FleetConfig(replicas=2)), s["wl"],
        **_inputs(s["corpus"], s["idx"], 2))
    assert [_ids(x) for x in got.shares] == [_ids(x) for x in want.shares]
    assert [(r.req_id, d.kind) for r, d in got.hits] == \
        [(r.req_id, d.kind) for r, d in want.hits]
    assert _ids(got.shed) == _ids(want.shed)
    assert _ids(got.misses) == _ids(want.misses)
    assert got.warmed == want.warmed
    assert got.hits and got.shed and got.warmed.get(1, 0) > 0


def test_serve_main_frontdoor_on_cpu(capsys):
    serve.main(["--device", "cpu", "--frontdoor", "--tenants", "3",
                "--replicas", "2", "--autoscale", "--check-tokens",
                "--requests", "16", "--docs", "12", "--max-new-tokens", "2",
                "--max-batch", "2", "--tenant-queries", "4"])
    out = capsys.readouterr().out
    assert "[frontdoor x2 (affinity)] 16 requests ->" in out
    assert "fleet: 2 replicas" in out and "front door" in out
    assert "front-door miss requests identical" in out


@pytest.mark.parametrize("argv", [
    ["--reuse", "chunk", "--check-tokens", "tol:1.0"],
    ["--replicas", "2", "--routing", "least_loaded", "--check-tokens"],
    ["--replicas", "2", "--sequential"]])
def test_serve_main_fleet_flags_on_cpu(capsys, argv):
    serve.main(["--device", "cpu", "--requests", "6", "--docs", "12",
                "--max-new-tokens", "2", "--max-batch", "2"] + argv)
    out = capsys.readouterr().out
    if "--check-tokens" in argv:
        assert "token check: all 6 requests" in out
    if "--sequential" in argv:
        assert "note: --replicas applies to the continuous engine" in out


def test_serve_main_tp_still_raises(capsys):
    """--tp serves the dense family (tests/test_torch_tp.py) and the MoE
    family (tests/test_torch_tp_moe.py), here in the 2D fleet; a tp that
    would split a KV head of Mixtral's (reduced: 2 KV heads) still raises
    before any device work."""
    argv = ["--device", "cpu", "--arch", "mixtral-8x7b", "--requests", "2",
            "--docs", "8"]
    serve.main(argv + ["--tp", "2", "--replicas", "2", "--check-tokens"])
    assert "token check: all 2 requests identical" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="shard a KV head"):
        _quiet(serve.main, argv + ["--tp", "4"])
