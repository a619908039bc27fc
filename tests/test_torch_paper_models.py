"""The paper's evaluation models in the port, on the CPU through the plain
attention versions, in f32, against the JAX package on the same params
(carried across through ``params_from_numpy``): Mistral-7B's reduced
config (GQA R 2, a 64-token window on every layer), LLaMA2-7B's (MHA), and
an hd-128 variant of each (d_model 512, 4 heads), made with
``dataclasses.replace`` on both sides.

Sequences run past the reduced window: the model steps see up to 96
cached keys, the runtimes serve two docs of mean 48 tokens and a question.
Model steps: logits and caches within 1e-5.  Runtimes: tokens equal and
first-token logits within 1e-4 (the ``tol:`` semantics of
``repro.launch.serve``), with the JAX index's clusters copied into the
port's index; chunk reuse also gives JAX's exact flags and reuse depths.
Inside the port the exact claims hold: chunked prefill gives the
unchunked tokens, the continuous runtime the sequential engine's.
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
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.runtime import ContinuousRuntime
# both runtimes on one constant clock for the module (test_torch_clock.py)
from test_torch_clock import constant_clock  # noqa: F401

EPS = 1e-4
STEP_EPS = 1e-5
PAGE, SCRATCH = 16, 0
N_REQ, N_DOCS, NEW = 6, 20, 3
# name -> (architecture, the replace() that makes the variant)
CONFIGS = {
    "mistral-reduced": ("mistral-7b", {}),
    "llama2-reduced": ("llama2-7b", {}),
    "mistral-hd128": ("mistral-7b", dict(d_model=512, n_heads=4)),
    "llama2-hd128": ("llama2-7b", dict(d_model=512, n_heads=4)),
}
NAMES = list(CONFIGS)


def _configs(name):
    arch, change = CONFIGS[name]
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32", **change)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **change)
    return jcfg, cfg


def _key(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


@pytest.fixture(scope="module", params=NAMES)
def weights(request):
    """JAX params with random norm scales (the init leaves them zero), and
    the port's through the flat dict the checkpoint writes."""
    jcfg, cfg = _configs(request.param)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        a = np.asarray(jnp.asarray(leaf, jnp.float32))
        if _key(path).endswith(("ln1", "ln2", "final_norm")):
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        flat[_key(path)] = a
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(flat[_key(p)], x.dtype), jp)
    return request.param, jcfg, cfg, jp, M.params_from_numpy(flat, cfg)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a_torch, b_jax, eps=STEP_EPS):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err <= eps, err


def test_head_shapes(weights):
    name, jcfg, cfg, _, _ = weights
    assert (cfg.hd, cfg.q_rep) == (jcfg.hd, jcfg.q_rep)
    assert cfg.hd == (128 if name.endswith("hd128") else 64)
    assert cfg.q_rep == (2 if name.startswith("mistral") else 1)
    assert set(cfg.layer_windows()) == (
        {64} if name.startswith("mistral") else {0})


@pytest.mark.parametrize("prefix_len", [0, 66])
def test_prefill_matches_jax(weights, prefix_len):
    _, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(prefix_len)
    B, S = 2, 30
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    shape = (cfg.n_layers, B, prefix_len, cfg.n_kv_heads, cfg.hd)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    jpc = {"k": _j(pk), "v": _j(pv)} if prefix_len else None
    tpc = {"k": _t(pk), "v": _t(pv)} if prefix_len else None
    jl, jc = JM.prefill(jcfg, jp, {"tokens": _j(toks)}, prefix_cache=jpc,
                        prefix_len=prefix_len)
    tl, tc = M.prefill(cfg, tp, _t(toks).long(), tpc, prefix_len)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_decode_step_matches_jax(weights):
    _, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(5)
    B, Smax = 3, 100
    shape = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.hd)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([96, 70, 1], np.int32)
    jl, jc = JM.decode_step(jcfg, jp, _j(toks), {"k": _j(kc), "v": _j(vc)},
                            _j(pos))
    cache = {"k": _t(kc), "v": _t(vc)}
    tl = M.decode_step(cfg, tp, _t(toks).long(), cache, _t(pos))
    _close(tl, jl)
    _close(cache["k"], jc["k"])
    _close(cache["v"], jc["v"])


def _paged_layout(rng, cfg, n_blocks):
    """Two ragged prefill rows: row 0 has 70 cached tokens (four full
    pages and one of 6) and computes 20 more, so its rows reach positions
    70-89, past the reduced window; row 1 computes 9 fresh tokens."""
    B, Sq, T = 2, 32, 10
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.full((B, T), SCRATCH, np.int32)
    counts = np.zeros((B, T), np.int32)
    starts = np.zeros((B, T), np.int32)
    wblk = np.full((B, Sq), SCRATCH, np.int32)
    wslot = np.zeros((B, Sq), np.int32)
    cached = [free.pop() for _ in range(5)]
    tables[0, :5] = cached
    counts[0, :5] = [16, 16, 16, 16, 6]
    starts[0, :5] = [0, 16, 32, 48, 64]
    new0 = [free.pop(), free.pop()]
    tables[0, 5:7], counts[0, 5:7], starts[0, 5:7] = new0, [16, 4], [70, 86]
    wblk[0, :16], wslot[0, :16] = new0[0], np.arange(16)
    wblk[0, 16:20], wslot[0, 16:20] = new0[1], np.arange(4)
    new1 = free.pop()
    tables[1, 0], counts[1, 0] = new1, 9
    wblk[1, :9], wslot[1, :9] = new1, np.arange(9)
    toks = rng.integers(0, cfg.vocab_size, (B, Sq)).astype(np.int32)
    q_start = np.array([70, 0], np.int32)
    q_len = np.array([20, 9], np.int32)
    return (toks, tables, counts, starts, q_start, q_len, wblk, wslot,
            (new0[1], new1))


def _pool_close(tk, jk):
    # block 0 is the scratch block: padding rows write it in no set order
    a = tk.float().numpy()[:, 1:]
    b = np.asarray(jnp.asarray(jk, jnp.float32))[:, 1:]
    assert np.max(np.abs(a - b)) <= STEP_EPS


def test_paged_steps_match_jax(weights):
    """A ragged prefill past the window, then a decode step for both rows
    on top of it."""
    _, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(2)
    n_blocks = 14
    shape = (cfg.n_layers, n_blocks, PAGE, cfg.n_kv_heads, cfg.hd)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    (toks, tables, counts, starts, q_start, q_len, wblk, wslot,
     last) = _paged_layout(rng, cfg, n_blocks)
    ins = (tables, counts, starts, q_start, q_len, wblk, wslot)
    jl, jk, jv = JM.paged_prefill_step(jcfg, jp, _j(toks), _j(kp), _j(vp),
                                       *map(_j, ins), attn_impl="jnp")
    tk, tv = _t(kp), _t(vp)
    tl = M.paged_prefill_step(cfg, tp, _t(toks).long(), [tk], [tv],
                              *map(_t, ins))
    _close(tl, jl)
    _pool_close(tk, jk)
    _pool_close(tv, jv)

    B, T = 3, tables.shape[1]
    dt = np.full((B, T), SCRATCH, np.int32)
    dc = np.zeros((B, T), np.int32)
    ds = np.zeros((B, T), np.int32)
    dt[:2], dc[:2], ds[:2] = tables, counts, starts
    dc[0, 6] += 1                                   # slot 4 of row 0's page
    dc[1, 0] += 1                                   # slot 9 of row 1's page
    dc[2, 0] = 1                                    # dummy row: scratch
    pos = np.array([91, 10, 1], np.int32)
    wb = np.array([last[0], last[1], SCRATCH], np.int32)
    ws = np.array([4, 9, 0], np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl2, jk2, jv2 = JM.paged_decode_step(
        jcfg, jp, _j(dtok), jk, jv, _j(dt), _j(dc), _j(ds), _j(wb), _j(ws),
        _j(pos), attn_impl="jnp")
    tl2 = M.paged_decode_step(cfg, tp, _t(dtok).long(), [tk], [tv], _t(dt),
                              _t(dc), _t(ds), _t(wb), _t(ws), _t(pos))
    _close(tl2, jl2)
    _pool_close(tk, jk2)
    _pool_close(tv, jv2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class FlippableIndex:
    """With ``reverse`` set every retrieval returns its docs in reversed
    order, so cached docs reappear at other positions."""

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


@pytest.fixture(scope="module")
def setup(weights):
    name, jcfg, cfg, jp, tp = weights
    kw = dict(mean_doc_tokens=48, vocab=cfg.vocab_size, seed=0)
    jcorpus, corpus = jax_corpus(N_DOCS, **kw), make_corpus(N_DOCS, **kw)
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=8, nprobe=4)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=8, nprobe=4)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    kw = dict(n_requests=N_REQ, rate=100.0, question_tokens=8,
              vocab=cfg.vocab_size, zipf_s=1.2, seed=1)
    return dict(name=name, jcfg=jcfg, cfg=cfg, jp=jp, params=tp,
                jcorpus=jcorpus, corpus=corpus, jidx=jidx, idx=idx,
                jwl=jax_workload(jcorpus, **kw), wl=make_workload(corpus, **kw))


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _port_serve(s, idx=None, rt=None, **conf):
    rt = rt or ContinuousRuntime(s["cfg"], s["params"], s["corpus"],
                                 idx or s["idx"],
                                 config=EngineConfig(top_k=2, **conf),
                                 device="cpu")
    return rt, sorted(rt.serve(s["wl"], max_new_tokens=NEW),
                      key=lambda r: r.req_id)


@pytest.fixture(scope="module")
def port_run(setup):
    return _port_serve(setup)[1]


def _assert_like_jax(got, want):
    assert [r.req_id for r in got] == [r.req_id for r in want]
    for a, b in zip(got, want):
        assert a.docs == b.docs
        assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)
        assert _linf(a.first_logits, b.first_logits) <= EPS, a.req_id


def test_runtime_matches_jax_past_the_window(setup, port_run):
    s = setup
    jrt = JaxRuntime(s["jcfg"], s["jp"], s["jcorpus"], s["jidx"],
                     config=JaxEngineConfig(top_k=2))
    want = sorted(jrt.serve(s["jwl"], max_new_tokens=NEW),
                  key=lambda r: r.req_id)
    _assert_like_jax(port_run, want)
    longest = max(sum(int(s["corpus"].doc_lengths[d]) for d in r.docs)
                  + 8 + NEW for r in port_run)
    assert longest > 64                     # the reduced window binds


def test_chunked_prefill_gives_the_same_tokens(setup, port_run):
    _, chunked = _port_serve(setup, prefill_chunk=5)
    assert [r.tokens for r in chunked] == [r.tokens for r in port_run]
    assert all(np.array_equal(a.first_logits, b.first_logits)
               for a, b in zip(chunked, port_run))


def test_chunk_reuse_matches_jax(setup):
    """Two passes, the second with every request's doc order reversed, so
    exact, relocated and missed docs all occur."""
    s = setup
    jidx, idx = FlippableIndex(s["jidx"]), FlippableIndex(s["idx"])
    conf = dict(top_k=2, attn="paged", reuse="chunk", block_size=8,
                recompute_tokens=8)
    jrt = JaxRuntime(s["jcfg"], s["jp"], s["jcorpus"], jidx,
                     config=JaxEngineConfig(**conf))
    rt = ContinuousRuntime(s["cfg"], s["params"], s["corpus"], idx,
                           config=EngineConfig(**conf), device="cpu")
    for flip in (False, True):
        jidx.reverse = idx.reverse = flip
        want = sorted(jrt.serve(s["jwl"], max_new_tokens=NEW),
                      key=lambda r: r.req_id)
        _, got = _port_serve(s, rt=rt)
        _assert_like_jax(got, want)
        assert [(r.exact, r.alpha, r.beta) for r in got] == \
            [(r.exact, r.alpha, r.beta) for r in want]
    assert any(not r.exact for r in got)
    # the runtimes' chunk counters also count speculative prefills, whose
    # launches follow measured iteration times: both must have reused
    # docs exactly and relocated them, not necessarily as often
    for m in (rt.metrics, jrt.metrics):
        assert min(m.exact_chunk_hits, m.reloc_chunk_hits) > 0


def test_serve_check_tokens_exact(setup, capsys):
    """serve.main --check-tokens exact for the registered reduced configs;
    its steps (continuous, sequential, token_mismatches) for the hd-128
    variants, which are not registered."""
    s = setup
    arch = CONFIGS[s["name"]][0]
    argv = ["--device", "cpu", "--arch", arch, "--requests", "4", "--docs",
            "12", "--doc-tokens", "48", "--max-new-tokens", "3",
            "--max-batch", "2", "--check-tokens", "exact"]
    if s["name"].endswith("reduced"):
        serve.main(argv)
        out = capsys.readouterr().out
        assert f"model={arch.split('-')[0]}-reduced" in out
        assert "token check: all 4 requests identical" in out
        return
    args = serve.build_parser().parse_args(argv)
    cfg = dataclasses.replace(s["cfg"], dtype="bfloat16")
    params = M.init_params(cfg, args.seed)
    corpus, idx, wl, _ = serve.make_data(args, cfg)
    cont, _ = serve.serve_continuous(cfg, params, corpus, idx, wl, args)
    seq, _ = serve.serve_sequential(cfg, params, corpus, idx, wl, args)
    assert len(cont) == 4
    assert serve.token_mismatches(zip(cont, seq), "exact", 0.0) == []


# ---------------------------------------------------------------------------
# row invariance
# ---------------------------------------------------------------------------

# (architecture, product) -> whether the card's probe found it row-variant
# without the fixed-slab helper (layers.py's docstring)
ROW_VARIANT = {
    ("qwen2-0.5b", "down"): True, ("mistral-7b", "k"): True,
    ("mistral-7b", "v"): True, ("mistral-7b", "down"): True,
    ("llama2-7b", "down"): True,
}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mistral-7b", "llama2-7b"])
def test_slab_rule_names_the_row_variant_products(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    c = get_config(arch)
    D, F, H, KV, hd = c.d_model, c.d_ff, c.n_heads, c.n_kv_heads, c.hd
    shapes = {"q": (D, H * hd), "k": (D, KV * hd), "v": (D, KV * hd),
              "o": (H * hd, D), "gate": (D, F), "up": (D, F),
              "down": (F, D), "logits": (D, c.vocab_size)}
    for name, shape in shapes.items():
        w = torch.empty(shape, device="meta")
        assert L.slabbed(w) == ROW_VARIANT.get((arch, name), False), name


def test_proj_gives_a_row_the_same_bits_at_any_row_count():
    """A product the rule slabs (K 4096, N 1024: Mistral-7B's k
    projection) through proj: a row's bits do not depend on how many rows
    share the call, and the slabs change values only by rounding."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(4)
    w = torch.from_numpy(0.02 * rng.standard_normal((4096, 1024))
                         .astype(np.float32)).to(torch.bfloat16)
    assert L.slabbed(w)
    n = L.ROW_SLAB + 40
    x = torch.from_numpy(rng.standard_normal((n, 4096)).astype(np.float32)
                         ).to(torch.bfloat16)
    full = L.proj(x, w)
    for m in (1, 7, L.ROW_SLAB, n):
        assert torch.equal(L.proj(x[:m], w), full[:m]), m
    plain = L.dense(x, w)
    assert torch.allclose(plain.float(), full.float(), atol=5e-2, rtol=2e-2)
