"""Chunk reuse (``reuse="chunk"``) in the port's ContinuousRuntime, on the
CPU through the plain attention versions, in f32.

The first six tests mirror the runtime tests of ``tests/test_chunk_reuse.py``
inside the port: exact hits are bit-identical, exact results equal the
port's sequential engine, relocated results stay within the tolerance they
report, a huge recompute budget degenerates to exact, the pool's blocks
balance, and the dense engine refuses chunk mode.

The last holds the port against the JAX package on the same params (carried
across through ``params_from_numpy``), corpus, workload and index clusters:
two passes through an index that reverses each request's doc order on the
second, so exact, relocated and miss placements all occur.  Greedy tokens
must be equal and first-token logits within 1e-4, relocated requests
included; the ``exact`` flags and the three chunk counters must be equal.
The module holds both runtimes on one constant clock (``constant_clock``
from ``test_torch_clock.py``), so their schedules follow the workload, not
the machine's speed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro.retrieval.corpus import make_corpus as jax_corpus
from repro.retrieval.corpus import make_workload as jax_workload
from repro.retrieval.vectordb import IVFIndex as JaxIVF
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.runtime import ContinuousRuntime as JaxRuntime
from repro_torch.configs import get_reduced
from repro_torch.launch.serve import token_mismatches
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import RAGServer
from repro_torch.serving.runtime import ContinuousRuntime
from test_torch_clock import constant_clock  # noqa: F401

EPS = 1e-4
NEW = 3
COUNTERS = ("exact_chunk_hits", "reloc_chunk_hits", "reloc_recompute_tokens")


class FlippableIndex:
    """Wraps an index; with ``reverse=True`` every retrieval returns the
    same doc set in reversed order, so cached docs reappear at other
    positions: the relocated-chunk case."""

    def __init__(self, base):
        self.base = base
        self.reverse = False

    def search(self, q, k, fraction=1.0):
        out = self.base.search(q, k, fraction)
        return out[::-1] if self.reverse else out

    def staged_search(self, q, k, fraction=1.0):
        for st in self.base.staged_search(q, k, fraction):
            yield (dataclasses.replace(st, topk=tuple(reversed(st.topk)))
                   if self.reverse else st)


def make_setup():
    jcfg = dataclasses.replace(jax_reduced("qwen2-0.5b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    params = M.params_from_numpy(flat, cfg)
    jcorpus = jax_corpus(16, mean_doc_tokens=24, vocab=cfg.vocab_size,
                         seed=0)
    corpus = make_corpus(16, mean_doc_tokens=24, vocab=cfg.vocab_size,
                         seed=0)
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=4, nprobe=4)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=4, nprobe=4)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    kw = dict(n_requests=6, rate=100.0, question_tokens=8,
              vocab=cfg.vocab_size, zipf_s=1.2, seed=1)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, params=params, jcorpus=jcorpus,
                corpus=corpus, jidx=jidx, idx=idx,
                jwl=jax_workload(jcorpus, **kw), wl=make_workload(corpus, **kw))


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _runtime(s, idx=None, **kw):
    kw.setdefault("recompute_tokens", 8)
    econf = EngineConfig(top_k=2, attn="paged", reuse="chunk", block_size=8,
                         **kw)
    return ContinuousRuntime(s["cfg"], s["params"], s["corpus"],
                             idx if idx is not None else s["idx"],
                             config=econf, device="cpu")


def _oracle(s, idx):
    srv = RAGServer(s["cfg"], s["params"], s["corpus"], idx,
                    config=EngineConfig(top_k=2), device="cpu")
    return sorted(srv.serve(s["wl"], max_new_tokens=NEW),
                  key=lambda r: r.req_id)


def _serve(rt, wl):
    return sorted(rt.serve(wl, max_new_tokens=NEW), key=lambda r: r.req_id)


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def test_chunk_mode_exact_hits_bit_identical(setup):
    """One request twice keeps its doc order, so pass 2 reuses both chunks
    exactly: alpha > 0, still flagged exact, tokens bit-identical."""
    rt = _runtime(setup)
    one = rt.serve([setup["wl"][0]], max_new_tokens=NEW)
    two = rt.serve([setup["wl"][0]], max_new_tokens=NEW)
    assert rt.metrics.exact_chunk_hits > 0
    assert rt.metrics.reloc_chunk_hits == 0
    assert one[0].exact and two[0].exact
    assert one[0].alpha == 0 and two[0].alpha > 0
    assert two[0].beta < one[0].beta
    assert one[0].tokens == two[0].tokens
    assert np.array_equal(one[0].first_logits, two[0].first_logits)


def test_chunk_mode_exact_results_match_oracle(setup):
    """The workload twice: doc order churns across requests, and every
    result flagged exact equals the sequential engine's tokens."""
    rt = _runtime(setup)
    _serve(rt, setup["wl"])
    res = _serve(rt, setup["wl"])
    seq = _oracle(setup, setup["idx"])
    assert any(a.exact for a in res)
    for a, b in zip(res, seq):
        if a.exact:
            assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)


def test_relocated_chunks_tolerance_bounded(setup):
    """Same docs, reversed order: relocated reuse is flagged exact=False, its
    first-token logits differ from the oracle's by a finite, nonzero
    amount, and the tol: comparator accepts it at that bound."""
    idx = FlippableIndex(setup["idx"])
    rt = _runtime(setup, idx)
    _serve(rt, setup["wl"])
    idx.reverse = True
    res = _serve(rt, setup["wl"])
    assert rt.metrics.reloc_chunk_hits > 0
    assert rt.metrics.reloc_recompute_tokens > 0
    assert any(not r.exact for r in res)
    seq = _oracle(setup, idx)
    linfs = [_linf(a.first_logits, b.first_logits) for a, b in zip(res, seq)]
    assert all(np.isfinite(d) for d in linfs)
    assert max(linfs) > 0.0
    eps = max(linfs) * 1.01 + 1e-9
    assert token_mismatches(list(zip(res, seq)), "tol", eps) == []
    for a, b in zip(res, seq):
        if a.exact:
            assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)


def test_huge_recompute_budget_degenerates_to_exact(setup):
    idx = FlippableIndex(setup["idx"])
    rt = _runtime(setup, idx, recompute_tokens=10_000)
    _serve(rt, setup["wl"])
    idx.reverse = True
    res = _serve(rt, setup["wl"])
    assert rt.metrics.reloc_chunk_hits == 0
    assert all(r.exact for r in res)
    for a, b in zip(res, _oracle(setup, idx)):
        assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)


def test_chunk_mode_block_accounting_balances(setup):
    idx = FlippableIndex(setup["idx"])
    rt = _runtime(setup, idx)
    _serve(rt, setup["wl"])
    idx.reverse = True
    _serve(rt, setup["wl"])
    assert rt.metrics.reloc_chunk_hits > 0
    rt.tree.check_invariants()
    tree_blocks = sum(len(n.payload_gpu.blocks) for n in rt.tree.nodes()
                      if n.in_gpu and n.payload_gpu is not None)
    live = rt.store.pool.n_blocks - rt.store.pool.free_blocks
    assert live == tree_blocks + 1      # + the scratch block
    rt.store.pool.check()
    assert not rt.running and not rt._partial_jobs


def test_chunk_mode_requires_paged(setup):
    with pytest.raises(ValueError, match="requires the paged engine"):
        ContinuousRuntime(setup["cfg"], setup["params"], setup["corpus"],
                          setup["idx"],
                          config=EngineConfig(top_k=2, attn="dense",
                                              reuse="chunk"), device="cpu")
    with pytest.raises(ValueError, match="reuse must be"):
        EngineConfig(top_k=2, reuse="suffix")


def compare_with_jax(s, chunk):
    """Two passes, the second with every request's doc order reversed,
    through both frameworks' runtimes; asserts they agree."""
    jidx = FlippableIndex(s["jidx"])
    idx = FlippableIndex(s["idx"])
    conf = dict(top_k=2, attn="paged", reuse="chunk", block_size=8,
                recompute_tokens=8, prefill_chunk=chunk)
    jrt = JaxRuntime(s["jcfg"], s["jp"], s["jcorpus"], jidx,
                     config=JaxEngineConfig(**conf))
    rt = ContinuousRuntime(s["cfg"], s["params"], s["corpus"], idx,
                           config=EngineConfig(**conf), device="cpu")
    for flip in (False, True):
        jidx.reverse = idx.reverse = flip
        want = sorted(jrt.serve(s["jwl"], max_new_tokens=NEW),
                      key=lambda r: r.req_id)
        got = _serve(rt, s["wl"])
        assert [r.req_id for r in got] == [r.req_id for r in want]
        for a, b in zip(got, want):
            assert a.docs == b.docs
            assert a.exact == b.exact, (a.req_id, a.exact, b.exact)
            assert (a.alpha, a.beta) == (b.alpha, b.beta)
            assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)
            linf = _linf(a.first_logits, b.first_logits)
            assert linf <= EPS, (a.req_id, flip, linf)
    assert any(not r.exact for r in got)
    for name in COUNTERS:
        assert getattr(rt.metrics, name) == getattr(jrt.metrics, name), name
    assert rt.metrics.reloc_chunk_hits > 0


@pytest.mark.parametrize("chunk", [0, 5])
def test_chunk_reuse_matches_jax_runtime(setup, chunk):
    """Two passes, the second with every request's doc order reversed,
    through both frameworks' runtimes (unchunked, and in 5-token pieces)."""
    compare_with_jax(setup, chunk)
