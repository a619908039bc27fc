"""The port's dense path — ``model.prefill`` / ``decode_step``, the
continuous runtime under ``attn="dense"`` and ``mode="cag"``, and the
sequential ``RAGServer`` — against the JAX package's, and the port's own
exact claims, all on the CPU through the plain versions.

Model: the reduced qwen2 with random biases and norm scales, params carried
across through the flat checkpoint; f32 logits within 1e-5 and caches
within 1e-5, bf16 logits within 5e-2 (the bound ``test_torch_model.py``
explains).  Serving: f32, the JAX index's clusters copied into the port's;
tokens equal, or first-token logits within 1e-4 (the ``tol:`` semantics).
Inside the port, in f32, the exact claims hold: the paged runtime gives
the sequential engine's tokens, CAG gives RAG's, a chunk split gives the
unchunked tokens.
"""
import dataclasses
import os

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
from repro.retrieval.corpus import make_workload as jax_workload
from repro.retrieval.vectordb import IVFIndex as JaxIVF
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import RAGServer as JaxRAGServer
from repro.serving.runtime import ContinuousRuntime as JaxRuntime
from repro.training import checkpoint
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import RAGServer
from repro_torch.serving.runtime import ContinuousRuntime
# both runtimes on one constant clock for the module (test_torch_clock.py)
from test_torch_clock import constant_clock  # noqa: F401

EPS = 1e-4
BF16_LOGIT_EPS = 5e-2
N_REQ, N_DOCS, NEW = 4, 12, 3
DISK = 1 << 24


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request, tmp_path_factory):
    """JAX params with random biases and norm scales, restored on both
    sides from the flat checkpoint."""
    dtype = request.param
    jcfg = dataclasses.replace(jax_reduced("qwen2-0.5b"), dtype=dtype)
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("ckpt") / f"qwen2_{dtype}.npz"
    checkpoint.save(str(path), jp)
    rng = np.random.default_rng(1)
    flat = dict(np.load(path))
    for key in ("blocks/bq", "blocks/bk", "blocks/bv", "blocks/ln1",
                "blocks/ln2", "final_norm"):
        flat[key] = (0.1 * rng.standard_normal(flat[key].shape)).astype(
            np.float32)
    np.savez(path, **flat)
    jp, _ = checkpoint.restore(str(path), jp)
    checkpoint.save(str(path), jp)
    return dtype, jcfg, cfg, jp, M.params_from_numpy(dict(np.load(path)),
                                                     cfg)


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(getattr(torch, dtype)) if dtype is not None else t


def _logits_close(a_torch, b_jax, dtype):
    eps = 1e-5 if dtype == "float32" else BF16_LOGIT_EPS
    err = float(np.max(np.abs(a_torch.float().numpy()
                              - np.asarray(b_jax, np.float32))))
    assert err <= eps, err


def _cache_close(a_torch, b_jax, dtype):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("prefix_len", [0, 21])
def test_prefill_matches_jax(weights, prefix_len):
    dtype, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(prefix_len)
    B, S = 2, 13
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    shape = (cfg.n_layers, B, prefix_len, cfg.n_kv_heads, cfg.hd)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    jpc = {"k": _j(pk, dtype), "v": _j(pv, dtype)} if prefix_len else None
    tpc = {"k": _t(pk, dtype), "v": _t(pv, dtype)} if prefix_len else None
    jl, jc = JM.prefill(jcfg, jp, {"tokens": _j(toks)}, prefix_cache=jpc,
                        prefix_len=prefix_len)
    tl, tc = M.prefill(cfg, tp, _t(toks).long(), tpc, prefix_len)
    assert tl.shape == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    _logits_close(tl, jl, dtype)
    for key in ("k", "v"):
        assert tc[key].dtype == cfg.tdtype
        _cache_close(tc[key], jc[key], dtype)


def test_decode_step_matches_jax(weights):
    dtype, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(5)
    B, Smax = 3, 24
    shape = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.hd)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([20, 7, 1], np.int32)
    jl, jc = JM.decode_step(jcfg, jp, _j(toks),
                            {"k": _j(kc, dtype), "v": _j(vc, dtype)},
                            _j(pos))
    cache = {"k": _t(kc, dtype), "v": _t(vc, dtype)}
    k_obj = cache["k"]
    tl = M.decode_step(cfg, tp, _t(toks).long(), cache, _t(pos))
    assert cache["k"] is k_obj                      # written in place
    _logits_close(tl, jl, dtype)
    _cache_close(cache["k"], jc["k"], dtype)
    _cache_close(cache["v"], jc["v"], dtype)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_reduced("qwen2-0.5b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = M.params_from_numpy(flat, cfg)
    jcorpus = jax_corpus(N_DOCS, mean_doc_tokens=16, vocab=cfg.vocab_size,
                         seed=0)
    corpus = make_corpus(N_DOCS, mean_doc_tokens=16, vocab=cfg.vocab_size,
                         seed=0)
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=8, nprobe=4)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=8, nprobe=4)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    kw = dict(n_requests=N_REQ, rate=100.0, question_tokens=8,
              vocab=cfg.vocab_size, zipf_s=1.2, seed=1)
    return (jcfg, cfg, jp, tp, jcorpus, corpus, jidx, idx,
            jax_workload(jcorpus, **kw), make_workload(corpus, **kw))


def _port(setup, **conf):
    _, cfg, _, tp, _, corpus, _, idx, _, wl = setup
    rt = ContinuousRuntime(cfg, tp, corpus, idx,
                           config=EngineConfig(top_k=2, **conf),
                           device="cpu")
    return rt, rt.serve(wl, max_new_tokens=NEW)


def _jax_rt(setup, **conf):
    jcfg, _, jp, _, jcorpus, _, jidx, _, jwl, _ = setup
    rt = JaxRuntime(jcfg, jp, jcorpus, jidx,
                    config=JaxEngineConfig(top_k=2, **conf))
    return rt, rt.serve(jwl, max_new_tokens=NEW)


def _agree(got, want):
    assert [r.req_id for r in got] == [r.req_id for r in want]
    for a, b in zip(got, want):
        assert a.docs == tuple(b.docs)
        linf = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                   - np.asarray(b.first_logits, np.float64))))
        assert a.tokens == list(b.tokens) or linf <= EPS, (a.req_id, linf)
        assert linf <= EPS, (a.req_id, linf)
        assert len(a.tokens) == NEW


def _leak_free(rt):
    rt.tree.check_invariants()
    rt.store.pool.check()
    live = rt.store.pool.n_blocks - rt.store.pool.free_blocks
    tree_blocks = sum(len(n.payload_gpu.blocks) for n in rt.tree.nodes()
                      if n.in_gpu and n.payload_gpu is not None)
    assert live == tree_blocks + 1                    # + the scratch block
    assert not rt.running and not rt._partial_jobs


@pytest.fixture(scope="module")
def paged_run(setup):
    return _port(setup)


@pytest.fixture(scope="module")
def dense_run(setup):
    return _port(setup, attn="dense")


@pytest.fixture(scope="module")
def cag_run(setup):
    return _port(setup, mode="cag", disk_cache_bytes=DISK)


@pytest.fixture(scope="module")
def seq_run(setup):
    _, cfg, _, tp, _, corpus, _, idx, _, wl = setup
    srv = RAGServer(cfg, tp, corpus, idx, config=EngineConfig(top_k=2),
                    device="cpu")
    return srv, sorted(srv.serve(wl, max_new_tokens=NEW),
                       key=lambda r: r.req_id)


def test_dense_runtime_matches_jax(setup, dense_run):
    rt, got = dense_run
    assert rt.attn == "dense"
    _agree(got, _jax_rt(setup, attn="dense")[1])
    _leak_free(rt)


def test_cag_runtime_matches_jax(setup, cag_run):
    rt, got = cag_run
    jrt, want = _jax_rt(setup, mode="cag", disk_cache_bytes=DISK)
    drop = lambda ps: {k: v for k, v in ps.items() if k != "seconds"}
    assert drop(rt.preload_stats) == drop(jrt.preload_stats)
    assert rt.preload_stats["docs"] == N_DOCS
    assert rt.metrics.retrieval_stages == jrt.metrics.retrieval_stages == 0
    _agree(got, want)
    _leak_free(rt)


def test_rag_server_matches_jax(setup, seq_run):
    jcfg, _, jp, _, jcorpus, _, jidx, _, jwl, _ = setup
    srv = JaxRAGServer(jcfg, jp, jcorpus, jidx,
                       config=JaxEngineConfig(top_k=2))
    want = sorted(srv.serve(jwl, max_new_tokens=NEW),
                  key=lambda r: r.req_id)
    _, got = seq_run
    _agree(got, want)
    assert [r.alpha for r in got] == [r.alpha for r in want]


def test_paged_runtime_gives_the_sequential_tokens(paged_run, seq_run):
    """The port's own oracle: --check-tokens exact, paged vs sequential."""
    _, cont = paged_run
    _, seq = seq_run
    assert serve.token_mismatches(zip(cont, seq), "exact", 0.0) == []


def test_dense_runtime_gives_the_paged_tokens(paged_run, dense_run):
    assert [r.tokens for r in dense_run[1]] == \
        [r.tokens for r in paged_run[1]]


def test_cag_gives_the_rag_tokens(paged_run, cag_run):
    assert [r.tokens for r in cag_run[1]] == \
        [r.tokens for r in paged_run[1]]


def test_dense_chunk_split_gives_the_same_tokens(setup, dense_run):
    rt, chunked = _port(setup, attn="dense", prefill_chunk=5)
    assert [r.tokens for r in chunked] == [r.tokens for r in dense_run[1]]
    _leak_free(rt)


def test_cag_disk_tier_files_are_removed_on_close(cag_run):
    rt, _ = cag_run
    root = rt.disk.root
    assert rt.disk.n_files > 0 and os.path.isdir(root)
    rt.disk.close()
    assert not os.path.exists(root)


@pytest.mark.parametrize("conf,exc", [
    (dict(attn="dense", reuse="chunk"), ValueError),
    (dict(mode="cag"), ValueError)])
def test_invalid_combinations_raise(setup, conf, exc):
    _, cfg, _, tp, _, corpus, _, idx, _, _ = setup
    with pytest.raises(exc):
        ContinuousRuntime(cfg, tp, corpus, idx, config=EngineConfig(**conf),
                          device="cpu")
    if conf.get("mode") == "cag":
        with pytest.raises(exc):
            RAGServer(cfg, tp, corpus, idx, config=EngineConfig(**conf),
                      device="cpu")


@pytest.mark.parametrize("value", [None, "exact", "tol:0.5", "tol:0"])
def test_check_mode_parser_matches_jax(value):
    assert serve.parse_check_mode(value) == jax_serve.parse_check_mode(value)


@pytest.mark.parametrize("value", ["tol:x", "tol:-1", "fuzzy"])
def test_check_mode_parser_rejects_like_jax(value):
    for fn in (serve.parse_check_mode, jax_serve.parse_check_mode):
        with pytest.raises(SystemExit):
            fn(value)


def test_token_mismatches_matches_jax():
    R = dataclasses.make_dataclass("R", ["req_id", "tokens",
                                         "first_logits"])
    lg = np.linspace(0.0, 1.0, 5)
    pairs = [(R(0, [1, 2], lg), R(0, [1, 2], lg + 9)),
             (R(1, [1, 2], lg), R(1, [1, 3], lg + 0.01)),
             (R(2, [4], lg), R(2, [5], lg + 0.2)),
             (R(3, [4], None), R(3, [5], lg))]
    for mode, eps in (("exact", 0.0), ("tol", 0.05)):
        assert serve.token_mismatches(pairs, mode, eps) == \
            jax_serve.token_mismatches(pairs, mode, eps)


@pytest.mark.parametrize("extra", [[], ["--mode", "cag"],
                                   ["--attn", "dense", "--prefill-chunk",
                                    "7"]])
def test_serve_main_check_tokens(capsys, extra):
    serve.main(["--device", "cpu", "--requests", "4", "--docs", "12",
                "--max-new-tokens", "3", "--max-batch", "2",
                "--check-tokens", *extra])
    out = capsys.readouterr().out
    assert "token check: all 4 requests identical" in out
    assert "[sequential] served 4 requests" in out
    if "cag" in extra:
        assert "[cag] preloaded 12 docs" in out


# ---------------------------------------------------------------------------
# row invariance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["row_slabs", "swiglu"])
def test_row_slabs_give_a_row_the_same_bits_at_any_row_count(op):
    """Through the fixed-slab helper a row's output is bit-identical
    whatever the number of rows in the call (the card's d_ff-deep GEMM
    needs it; here it holds by construction), and the helper changes
    values only by rounding."""
    from repro_torch.models import layers as L
    cfg = get_reduced("qwen2-0.5b")
    p = {k: w[0] for k, w in M.init_params(cfg, 0)["blocks"].items()}
    fn = {"row_slabs": lambda t: L.row_slabs(
              lambda r: L.dense(r, p["wq"], p["bq"]), t),
          "swiglu": lambda t: L.swiglu(t, p["wg"], p["wu"], p["wd"])}[op]
    rng = np.random.default_rng(3)
    n = L.ROW_SLAB + 150
    x = torch.from_numpy(rng.standard_normal((2, n, cfg.d_model))
                         .astype(np.float32)).to(cfg.tdtype)
    full = fn(x)
    for b, m in ((0, 1), (1, 7), (0, L.ROW_SLAB), (1, L.ROW_SLAB + 1),
                 (0, n)):
        assert torch.equal(fn(x[b, :m]), full[b, :m]), (b, m)
    slab = L.ROW_SLAB
    try:
        L.ROW_SLAB = 0
        plain = fn(x)
    finally:
        L.ROW_SLAB = slab
    assert torch.allclose(plain.float(), full.float(), atol=5e-2, rtol=2e-2)
