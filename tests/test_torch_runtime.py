"""The slice as a whole: the port's ContinuousRuntime (on the CPU, through
the plain attention versions) against the JAX package's on the same
corpus, workload, params and index, in f32.

The two IVF k-means differ (numpy vs jax.random), so the port's index
takes the JAX index's clusters; search is numpy on both sides after that.
Tokens must be equal for every request, or the first-token logits agree
within 1e-4 (the ``tol:`` semantics of ``repro.launch.serve``).
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
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig, MeshConfig
from repro_torch.serving.runtime import ContinuousRuntime
# both runtimes on one constant clock for the module (test_torch_clock.py)
from test_torch_clock import constant_clock  # noqa: F401

EPS = 1e-4
N_REQ, N_DOCS, NEW = 6, 20, 3


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_reduced("qwen2-0.5b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = M.params_from_numpy(flat, cfg)
    jcorpus = jax_corpus(N_DOCS, mean_doc_tokens=24, vocab=cfg.vocab_size,
                         seed=0)
    corpus = make_corpus(N_DOCS, mean_doc_tokens=24, vocab=cfg.vocab_size,
                         seed=0)
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=8, nprobe=4)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=8, nprobe=4)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    kw = dict(n_requests=N_REQ, rate=100.0, question_tokens=8,
              vocab=cfg.vocab_size, zipf_s=1.2, seed=1)
    jwl = jax_workload(jcorpus, **kw)
    wl = make_workload(corpus, **kw)
    return jcfg, cfg, jp, tp, jcorpus, corpus, jidx, idx, jwl, wl


def _port_run(setup, **conf):
    _, cfg, _, tp, _, corpus, _, idx, _, wl = setup
    rt = ContinuousRuntime(cfg, tp, corpus, idx,
                           config=EngineConfig(top_k=2, **conf),
                           device="cpu")
    return rt, rt.serve(wl, max_new_tokens=NEW)


@pytest.fixture(scope="module")
def port_run(setup):
    return _port_run(setup)


def test_inputs_are_identical(setup):
    _, _, _, _, jcorpus, corpus, jidx, idx, jwl, wl = setup
    assert all(np.array_equal(a, b) for a, b in
               zip(jcorpus.doc_tokens, corpus.doc_tokens))
    for a, b in zip(jwl, wl):
        assert (a.req_id, a.arrival) == (b.req_id, b.arrival)
        assert np.array_equal(a.question_tokens, b.question_tokens)
        assert jidx.search(a.query_vec, 2) == idx.search(b.query_vec, 2)


def test_tokens_match_jax_runtime(setup, port_run):
    jcfg, _, jp, _, jcorpus, _, jidx, _, jwl, _ = setup
    jrt = JaxRuntime(jcfg, jp, jcorpus, jidx,
                     config=JaxEngineConfig(top_k=2))
    want = jrt.serve(jwl, max_new_tokens=NEW)
    _, got = port_run
    assert [r.req_id for r in got] == [r.req_id for r in want]
    for a, b in zip(got, want):
        assert a.docs == b.docs
        linf = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                   - np.asarray(b.first_logits, np.float64))))
        assert a.tokens == b.tokens or linf <= EPS, (a.req_id, linf)
        assert linf <= EPS, (a.req_id, linf)
        assert len(a.tokens) == NEW


def test_pool_leak_invariant(port_run):
    rt, _ = port_run
    rt.tree.check_invariants()
    rt.store.pool.check()
    live = rt.store.pool.n_blocks - rt.store.pool.free_blocks
    tree_blocks = sum(len(n.payload_gpu.blocks) for n in rt.tree.nodes()
                      if n.in_gpu and n.payload_gpu is not None)
    assert live == tree_blocks + 1                    # + the scratch block
    assert not rt.running and not rt._partial_jobs


def test_chunked_prefill_gives_the_same_tokens(setup, port_run):
    _, whole = port_run
    _, chunked = _port_run(setup, prefill_chunk=5)
    assert [r.tokens for r in chunked] == [r.tokens for r in whole]


@pytest.mark.parametrize("conf", [dict(attn="dense", mesh=MeshConfig(tp=2)),
                                  dict(reuse="chunk", mesh=MeshConfig(tp=2)),
                                  dict(mode="cag", disk_cache_bytes=1 << 20,
                                       mesh=MeshConfig(tp=2)),
                                  dict(mesh=MeshConfig(tp=2))])
def test_unported_options_raise(setup, conf):
    """Tensor parallelism serves the dense family (tests/test_torch_tp.py)
    and, alone or under the dense, chunk-reuse and CAG paths, the MoE
    family: its tp 2 gives the tokens and first-token logits of tp 1 over
    a one-device mesh of its column-slab group.  The recurrent families
    stay refused by the runtime, under a mesh too."""
    from repro_torch.launch.mesh import make_serving_mesh
    _, _, _, _, _, corpus, _, idx, _, wl = setup
    cfg = get_reduced("mixtral-8x7b")
    params = M.init_params(cfg, 0)
    runs = []
    for tp in (2, 1):
        config = dataclasses.replace(EngineConfig(**conf),
                                     mesh=MeshConfig(tp=tp))
        rt = ContinuousRuntime(cfg, params, corpus, idx, config=config,
                               device="cpu",
                               mesh=make_serving_mesh(tp, device="cpu",
                                                      slabs=2))
        runs.append(sorted(rt.serve(wl[:4], max_new_tokens=2),
                           key=lambda r: r.req_id))
    assert [r.tokens for r in runs[0]] == [r.tokens for r in runs[1]]
    for a, b in zip(*runs):
        assert np.array_equal(a.first_logits, b.first_logits), a.req_id
    hymba = get_reduced("hymba-1.5b")
    with pytest.raises(ValueError, match="recurrent"):
        ContinuousRuntime(hymba, M.init_params(hymba, 0), corpus, idx,
                          config=EngineConfig(**conf), device="cpu")


def test_default_device_is_the_card(setup):
    _, cfg, _, tp, _, corpus, _, idx, _, _ = setup
    if torch.cuda.is_available():
        rt = ContinuousRuntime(cfg, tp, corpus, idx, n_blocks=128)
        assert rt.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousRuntime(cfg, tp, corpus, idx, n_blocks=128)


def test_serve_main_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "4", "--docs", "12",
                "--max-new-tokens", "2", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "[continuous] served 4 requests" in out
    assert "TTFT (ms)" in out and "tier hits (tokens)" in out
