"""The rest of the dense family in the port, on the CPU through the plain
attention versions, against the JAX package on the same inputs: Gemma3-12B
(head dim 256, a window on 5 of every 6 layers), Gemma2-27B (windows on
every other layer, attention and final softcaps), Yi-34B (R 7) and
LLaMA2-70B (R 8), each at its reduced config, plus an hd-256 variant of
Gemma3's reduced config (whose own head dim is 64), made with
``dataclasses.replace`` on both sides.

Kernels: the plain versions of all three at hd 256 against the JAX
package's jnp versions and oracles (f32 within 1e-5, bf16 within 2e-2)
and against its Pallas kernels in interpret mode (f32).  Model steps, with
params carried across through ``params_from_numpy``: logits and caches in
f32 within 1e-4.  Runtimes: tokens equal and first-token logits within
1e-4, with the JAX index's clusters copied into the port's index; inside
the port chunked prefill gives the unchunked tokens.  ``serve.main
--check-tokens exact`` holds for each registered architecture; the
published configs' param trees (drawn on the meta device) equal the
reference's, and ``--full-size`` refuses LLaMA2-70B's 138 GB of weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.kernels import ops as jax_ops
from repro.kernels import prefix_attention as jax_pa
from repro.kernels import ref as jax_ref
from repro.models import model as JM
from repro.retrieval.corpus import make_corpus as jax_corpus
from repro.retrieval.corpus import make_workload as jax_workload
from repro.retrieval.vectordb import IVFIndex as JaxIVF
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.runtime import ContinuousRuntime as JaxRuntime
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import paged_prefill as PP
from repro_torch.kernels import prefix_attention as PX
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.runtime import ContinuousRuntime
# both runtimes on one constant clock for the module (test_torch_clock.py)
from test_torch_clock import constant_clock  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
EPS = 1e-4
PAGE, SCRATCH = 16, 0
N_REQ, N_DOCS, NEW = 4, 12, 3
ARCHS = ["gemma3-12b", "gemma2-27b", "yi-34b", "llama2-70b"]
# name -> (architecture, the replace() that makes the variant)
CONFIGS = {
    "gemma3-reduced": ("gemma3-12b", {}),
    "gemma2-reduced": ("gemma2-27b", {}),
    "yi-reduced": ("yi-34b", {}),
    "llama2-70b-reduced": ("llama2-70b", {}),
    "gemma3-hd256": ("gemma3-12b", dict(head_dim=256)),
}
NAMES = list(CONFIGS)


# ---------------------------------------------------------------------------
# the plain kernel versions at hd 256
# ---------------------------------------------------------------------------

def _runs(seg_lens, free):
    tables, counts, starts, pos = [], [], [], 0
    for n in seg_lens:
        for off in range(0, n, PAGE):
            tables.append(int(free.pop()))
            counts.append(min(PAGE, n - off))
            starts.append(pos + off)
        pos += n
    return tables, counts, starts, pos


def _tables(rng, rows, n_slots):
    """rows[b]: segment lengths; page 0 is scratch."""
    n_pages = 2 + sum(-(-n // PAGE) for segs in rows for n in segs)
    free = list(rng.permutation(np.arange(1, n_pages)))
    ints = [np.zeros((len(rows), n_slots), np.int32) for _ in range(3)]
    ends = []
    for b, segs in enumerate(rows):
        t, c, s, total = _runs(segs, free)
        for a, vals in zip(ints, (t, c, s)):
            a[b, :len(vals)] = vals
        ends.append(total)
    return ints, ends, n_pages


def _pool(rng, n_pages, KV, hd):
    shape = (2, n_pages, PAGE, KV, hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def decode_inputs(seed, R=2, KV=2, hd=256):
    """Rows of docs and a question past a 24-token window; row 1 empty."""
    rng = np.random.default_rng(seed)
    rows = [[20, 13, 5], [], [16, 40, 3], [7]]
    (tables, counts, starts), ends, n_pages = _tables(rng, rows, 10)
    k, v = _pool(rng, n_pages, KV, hd)
    q = rng.standard_normal((len(rows), R * KV, hd)).astype(np.float32)
    qpos = np.array([max(e - 1, 0) for e in ends], np.int32)
    return q, k, v, tables, counts, starts, qpos


def prefill_inputs(seed, R=2, KV=2, hd=256, Sq=32):
    """A chunk after cached docs, a fresh row, a padding row and a short
    chunk after one doc."""
    rng = np.random.default_rng(seed)
    rows = [([20, 13], 24), ([], 17), ([], 0), ([33], 5)]
    (tables, counts, starts), ends, n_pages = _tables(
        rng, [list(p) + [ql] if ql else [] for p, ql in rows], 12)
    q_len = np.array([ql for _, ql in rows], np.int32)
    q_start = np.array([e - ql if ql else 0
                        for e, (_, ql) in zip(ends, rows)], np.int32)
    k, v = _pool(rng, n_pages, KV, hd)
    q = rng.standard_normal((len(rows), R * KV, Sq, hd)).astype(np.float32)
    return q, k, v, tables, counts, starts, q_start, q_len


def prefix_inputs(seed, R=2, KV=2, hd=256, prefix=150, Sq=37):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, R * KV, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((1, KV, prefix + Sq, hd)).astype(np.float32)
    v = rng.standard_normal((1, KV, prefix + Sq, hd)).astype(np.float32)
    return q, k, v


def _to_jax(arrs, dtype):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrs]


def _to_torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            if a.dtype == np.float32 else torch.from_numpy(a) for a in arrs]


def _close_k(a_torch, b_jax, dtype):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= TOL[dtype], err
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 50.0)])
def test_decode_plain_matches_jax_at_hd256(dtype, window, cap):
    ins = decode_inputs(3 + window)
    jx, tt = _to_jax(ins, dtype), _to_torch(ins, dtype)
    want = jax_ops.paged_decode_attention(*jx, 1, window, logit_cap=cap,
                                          impl="jnp")
    got = ops.paged_decode_attention(*tt, 1, window, logit_cap=cap)
    assert got.dtype == getattr(torch, dtype)
    out = _close_k(got, want, dtype)
    assert (out[1] == 0).all()                    # all-empty row -> exact 0
    oracle = jax_ref.reference_paged_decode(*jx, 1, window, cap)
    _close_k(got, oracle, dtype)
    _close_k(ref.reference_paged_decode(*tt, 1, window, cap), oracle, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 50.0)])
def test_prefill_plain_matches_jax_at_hd256(dtype, window, cap):
    ins = prefill_inputs(4 + window)
    jx, tt = _to_jax(ins, dtype), _to_torch(ins, dtype)
    want = jax_ops.paged_prefill_attention(*jx, 1, window, logit_cap=cap,
                                           impl="jnp")
    got = ops.paged_prefill_attention(*tt, 1, window, logit_cap=cap)
    out = _close_k(got, want, dtype)
    q_len = ins[-1]
    for b in range(len(q_len)):
        assert (out[b, :, q_len[b]:] == 0).all()  # padding rows -> exact 0
    oracle = jax_ref.reference_paged_prefill(*jx, 1, window, cap)
    _close_k(got, oracle, dtype)
    _close_k(ref.reference_paged_prefill(*tt, 1, window, cap), oracle, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 50.0)])
def test_prefix_plain_matches_jax_at_hd256(dtype, window, cap):
    ins = prefix_inputs(5 + window)
    jx, tt = _to_jax(ins, dtype), _to_torch(ins, dtype)
    want = jax_ref.reference_prefix_attention(*jx, prefix_len=150,
                                              window=window, logit_cap=cap)
    got = ops.prefix_attention(*tt, prefix_len=150, window=window,
                               logit_cap=cap)
    assert got.dtype == getattr(torch, dtype)
    _close_k(got, want, dtype)
    _close_k(ref.reference_prefix_attention(*tt, prefix_len=150,
                                            window=window, logit_cap=cap),
             want, dtype)


@pytest.mark.parametrize("kernel", ["decode", "prefill", "prefix"])
def test_plain_matches_pallas_interpret_at_hd256(kernel):
    """Against the Pallas kernel bodies themselves (interpret mode, f32,
    hd 256, with a window)."""
    if kernel == "decode":
        ins = decode_inputs(6)
        want = jax_ops.paged_decode_attention(*_to_jax(ins, "float32"), 1,
                                              24, impl="interpret")
        got = PA.paged_decode_torch(*_to_torch(ins, "float32"), 1, 24)
    elif kernel == "prefill":
        ins = prefill_inputs(7)
        want = jax_ops.paged_prefill_attention(*_to_jax(ins, "float32"), 1,
                                               24, impl="interpret")
        got = PP.paged_prefill_torch(*_to_torch(ins, "float32"), 1, 24)
    else:
        ins = prefix_inputs(8)
        want = jax_pa.prefix_flash_attention(
            *_to_jax(ins, "float32"), prefix_len=150, window=24,
            block_q=64, block_k=64, interpret=True)
        got = PX.prefix_attention_torch(*_to_torch(ins, "float32"),
                                        prefix_len=150, window=24)
    _close_k(got, want, "float32")


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------

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


def _close(a_torch, b_jax, eps=EPS):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err <= eps, err


def test_head_shapes(weights):
    name, jcfg, cfg, _, _ = weights
    assert (cfg.hd, cfg.q_rep, cfg.layer_windows()) == \
        (jcfg.hd, jcfg.q_rep, jcfg.layer_windows())
    want = {"gemma3-reduced": (64, 2), "gemma2-reduced": (64, 2),
            "yi-reduced": (64, 7), "llama2-70b-reduced": (32, 8),
            "gemma3-hd256": (256, 2)}[name]
    assert (cfg.hd, cfg.q_rep) == want
    if name.startswith("gemma"):
        assert cfg.layer_windows() == (64, 0)     # one window, one global
    if name.startswith("gemma2"):
        assert (cfg.attn_logit_softcap, cfg.final_logit_softcap) == \
            (50.0, 30.0)


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
    """Two ragged prefill rows: row 0 has 70 cached tokens and computes 20
    more, past the reduced window of 64; row 1 computes 9 fresh tokens."""
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
    assert np.max(np.abs(a - b)) <= EPS


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


def _port_serve(s, **conf):
    rt = ContinuousRuntime(s["cfg"], s["params"], s["corpus"], s["idx"],
                           config=EngineConfig(top_k=2, **conf),
                           device="cpu")
    return sorted(rt.serve(s["wl"], max_new_tokens=NEW),
                  key=lambda r: r.req_id)


@pytest.fixture(scope="module")
def port_run(setup):
    return _port_serve(setup)


def test_runtime_matches_jax(setup, port_run):
    s = setup
    jrt = JaxRuntime(s["jcfg"], s["jp"], s["jcorpus"], s["jidx"],
                     config=JaxEngineConfig(top_k=2))
    want = sorted(jrt.serve(s["jwl"], max_new_tokens=NEW),
                  key=lambda r: r.req_id)
    assert [r.req_id for r in port_run] == [r.req_id for r in want]
    for a, b in zip(port_run, want):
        assert a.docs == b.docs
        assert a.tokens == b.tokens, (a.req_id, a.tokens, b.tokens)
        assert _linf(a.first_logits, b.first_logits) <= EPS, a.req_id
    if s["cfg"].sliding_window:
        longest = max(sum(int(s["corpus"].doc_lengths[d]) for d in r.docs)
                      + 8 + NEW for r in port_run)
        assert longest > s["cfg"].sliding_window   # the window binds


def test_chunked_prefill_gives_the_same_tokens(setup, port_run):
    """Tokens equal and first-token logits within f32 rounding: the CPU's
    GEMMs may sum a row in another order at another row count (Yi's
    reduced widths do), so bit identity is the card's claim, where
    chip_smoke.py checks it at the published widths."""
    chunked = _port_serve(setup, prefill_chunk=5)
    assert [r.tokens for r in chunked] == [r.tokens for r in port_run]
    assert max(_linf(a.first_logits, b.first_logits)
               for a, b in zip(chunked, port_run)) <= 1e-5


def test_serve_check_tokens_exact(setup, capsys):
    """serve.main --check-tokens exact for the registered reduced configs;
    its steps (continuous, sequential, token_mismatches) for the hd-256
    variant, which is not registered."""
    s = setup
    arch = CONFIGS[s["name"]][0]
    argv = ["--device", "cpu", "--arch", arch, "--requests", "4", "--docs",
            "12", "--doc-tokens", "48", "--max-new-tokens", "3",
            "--max-batch", "2", "--check-tokens", "exact"]
    if s["name"].endswith("reduced"):
        serve.main(argv)
        out = capsys.readouterr().out
        assert f"model={s['name']}" in out
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
# full size
# ---------------------------------------------------------------------------

# n_params() and K/V bytes a token (bf16, all layers)
FULL = {"gemma3-12b": (11_765_022_720, 393_216),
        "gemma2-27b": (27_226_275_840, 376_832),
        "yi-34b": (34_388_049_920, 245_760),
        "llama2-70b": (68_975_329_280, 327_680)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tree_matches_the_reference(arch):
    """The published config's params drawn on the meta device: the
    reference's tree (keys, shapes, dtypes, from ``eval_shape``) and its
    n_params()."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    want = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    want = {_key(p): (tuple(x.shape), str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {}

    def walk(d, pre):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                got[f"{pre}{k}"] = (tuple(v.shape),
                                    str(v.dtype).removeprefix("torch."))
    walk(M.init_params(cfg, 0, "meta"), "")
    assert got == want
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert cfg.n_params() == jcfg.n_params() == FULL[arch][0]
    # n_params() leaves out the norms' scales
    assert n == FULL[arch][0] + (2 * cfg.n_layers + 1) * cfg.d_model
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * cfg.tdtype.itemsize
    assert kv == FULL[arch][1]


def test_full_size_draws_the_large_stacks_a_layer_at_a_time():
    """The rule of init_params: stacks whose whole f32 draw passes
    WHOLE_DRAW_BYTES go a layer at a time (all four here), the others
    whole (Mistral-7B's largest, 7.5 GB, stays under it)."""
    for arch in ARCHS + ["mistral-7b", "llama2-7b"]:
        c = get_config(arch)
        big = 4 * c.n_layers * c.d_model * max(c.d_ff, c.n_heads * c.hd)
        assert (big > M.WHOLE_DRAW_BYTES) == (arch in ARCHS), arch


def test_full_size_llama2_70b_needs_tensor_parallelism():
    with pytest.raises(ValueError, match=r"138\.0 GB.*tensor parallelism"):
        serve.main(["--device", "cpu", "--full-size", "--arch",
                    "llama2-70b"])


def test_layer_at_a_time_draw_keeps_the_tree(monkeypatch):
    """The layer-at-a-time draw, forced on a reduced config: the same tree
    and dtypes, every stack at the init's scale, the tensors drawn before
    the stacks unchanged."""
    cfg = get_reduced("gemma3-12b")
    whole = M.init_params(cfg, 0)
    monkeypatch.setattr(M, "WHOLE_DRAW_BYTES", 0)
    sliced = M.init_params(cfg, 0)
    assert torch.equal(sliced["embed"], whole["embed"])
    for key, w in whole["blocks"].items():
        s = sliced["blocks"][key]
        assert (s.shape, s.dtype) == (w.shape, w.dtype), key
        if key.startswith("ln"):
            assert torch.equal(s, w)
        else:
            std = s.float().std().item()
            want = 0.02 if key != "wo" and key != "wd" else \
                0.02 / (2 * cfg.n_layers) ** 0.5
            assert abs(std / want - 1) < 0.1, (key, std)
            assert not torch.equal(s[0], s[1])    # each layer its own draw


# products layers.slabbed runs in fixed row slabs at each model's widths.
# On the card (chip_smoke.py's probe) Gemma3-12B's k and v (K 3840, N
# 2048) were row-variant without them; every product deeper than 4096 is
# slabbed; o at K 4096 and Gemma3's q, gate and up (N >= 4096) are not.
SLABBED = {"gemma3-12b": {"k", "v", "down"},
           "gemma2-27b": {"q", "k", "v", "gate", "up", "down", "logits"},
           "yi-34b": {"q", "k", "v", "o", "gate", "up", "down", "logits"},
           "llama2-70b": {"q", "k", "v", "o", "gate", "up", "down",
                          "logits"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_slab_rule_at_the_new_widths(arch):
    from repro_torch.models import layers as L
    c = get_config(arch)
    D, F, H, KV, hd = c.d_model, c.d_ff, c.n_heads, c.n_kv_heads, c.hd
    shapes = {"q": (D, H * hd), "k": (D, KV * hd), "v": (D, KV * hd),
              "o": (H * hd, D), "gate": (D, F), "up": (D, F),
              "down": (F, D), "logits": (D, c.vocab_size)}
    got = {name for name, shape in shapes.items()
           if L.slabbed(torch.empty(shape, device="meta"))}
    assert got == SLABBED[arch]
