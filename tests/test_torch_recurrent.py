"""The recurrent-state and audio families in the port, on the CPU in f32,
against the JAX package on the same params (carried across through
``params_from_numpy``): xLSTM-1.3B's reduced config (one period of an
mLSTM and an sLSTM block), Hymba-1.5B's (attention with R 5 and a
64-token window, then the SSM branch) and MusicGen-large's (4 codebooks).

Tolerances, all f32:
- the scans: 1e-4 x max(1, max |reference|).  mLSTM outputs are a
  quotient, num / max(|den|, floor), and reach |h| ~ 35 where the
  normaliser is small; there the reference's own two forms
  (``mlstm_scan`` and ``mlstm_chunkwise``) differ by 1.4e-4, and the port's
  by the same few ulps of h;
- model steps: 1e-5 (logits and caches);
- the engine: tokens equal, first-token logits within 1e-4.

The reference's ``mlstm_chunkwise`` multiplies the chunk's scores by the
causal mask; once a chunk spans ~128 steps its masked weights overflow to
inf and inf x 0 makes its outputs NaN.  The port masks with a select: the
chunkwise inputs here keep the reference finite (forget-gate
pre-activations near 3), the engine's segments stay under 100 tokens, and
one test holds the port's chunkwise form to the reference's recurrent one
where the reference's chunkwise form is NaN.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import layers as JL
from repro.models import model as JM
from repro.retrieval.corpus import make_corpus as jax_corpus
from repro.retrieval.corpus import make_workload as jax_workload
from repro.retrieval.vectordb import IVFIndex as JaxIVF
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import RAGServer as JaxRAGServer
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import RAGServer
from repro_torch.serving.runtime import ContinuousRuntime
# both runtimes on one constant clock for the module (test_torch_clock.py)
from test_torch_clock import constant_clock  # noqa: F401

SCAN_TOL = 1e-4
STEP_EPS = 1e-5
EPS = 1e-4
N_REQ, N_DOCS, NEW = 3, 8, 3
ARCHS = {"xlstm-reduced": "xlstm-1.3b", "hymba-reduced": "hymba-1.5b",
         "musicgen-reduced": "musicgen-large"}
# billed GPU-tier bytes that hold about two of the corpus's doc nodes, so
# that serving evicts snapshots to the host tier and a hit promotes one
# back: 4 B a token for xLSTM, 1,024 B a token of f32 K/V for Hymba
GPU_TIER = {"xlstm-reduced": 320, "hymba-reduced": 81_920}


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(got, want):
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want, jnp.float32))
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))


def _scan_close(got, want):
    err, top = _err(got, want)
    assert np.isfinite(err) and err <= SCAN_TOL * max(1.0, top), (err, top)


def _close(got, want, eps=STEP_EPS):
    err, _ = _err(got, want)
    assert err <= eps, err


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = _rng(1)
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) \
        if with_state else None
    jy, js = JL.causal_conv1d(x, w, st)
    ty, ts = L.causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
    _scan_close(ty, jy)
    _scan_close(ts, js)


def _mlstm_inputs(seed, S, f_mean=3.0, B=2, H=2, hd=16):
    rng = _rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (f_mean + rng.standard_normal((B, S, H))).astype(np.float32)
    return q, k, v, ig, fg


def _mlstm_state(seed, B=2, H=2, hd=16):
    rng = _rng(seed)
    return (rng.standard_normal((B, H, hd, hd)).astype(np.float32),
            rng.standard_normal((B, H, hd)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_scan_matches_jax(with_state):
    ins = _mlstm_inputs(2, 40)
    st = _mlstm_state(3) if with_state else None
    jh, js = JL.mlstm_scan(*ins, state=st)
    th, ts = L.mlstm_scan(*map(_t, ins),
                          state=None if st is None else tuple(map(_t, st)))
    _scan_close(th, jh)
    for a, b in zip(ts, js):
        _scan_close(a, b)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [100, 300])
def test_mlstm_chunkwise_matches_jax(S, with_state):
    """S 100: one chunk of 100; S 300: chunks of 256, the last padded."""
    ins = _mlstm_inputs(4 + S, S)
    st = _mlstm_state(5) if with_state else None
    jh, js = JL.mlstm_chunkwise(*ins, state=st)
    th, ts = L.mlstm_chunkwise(*map(_t, ins),
                               state=None if st is None else tuple(map(_t, st)))
    _scan_close(th, jh)
    for a, b in zip(ts, js):
        _scan_close(a, b)
    # and the reference's own claim: chunkwise == recurrent
    rh, _ = L.mlstm_scan(*map(_t, ins),
                         state=None if st is None else tuple(map(_t, st)))
    _scan_close(th, rh.numpy())


def test_mlstm_chunkwise_where_the_reference_overflows():
    """Forget gates near 0 (log f ~ -0.69 a step): past ~128 steps of one
    chunk the reference's chunkwise outputs are NaN; the port's equal the
    reference's recurrent form."""
    ins = _mlstm_inputs(6, 300, f_mean=0.0)
    jh, _ = JL.mlstm_chunkwise(*ins)
    assert not np.isfinite(np.asarray(jh)).all()
    want, _ = JL.mlstm_scan(*ins)
    th, _ = L.mlstm_chunkwise(*map(_t, ins))
    _scan_close(th, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_jax(with_state):
    """S 300 crosses the reference's 256-step chunked_scan and its padded,
    masked steps."""
    rng = _rng(7)
    B, S, H, hd = 2, 300, 2, 8
    z = rng.standard_normal((B, S, H, 4 * hd)).astype(np.float32)
    rw = (0.3 * rng.standard_normal((H, hd, 4 * hd))).astype(np.float32)
    st = tuple(rng.standard_normal((B, H, hd)).astype(np.float32)
               for _ in range(4)) if with_state else None
    if st is not None:
        st = (st[0], np.abs(st[1]) + 1.0, st[2], st[3])
    jh, js = JL.slstm_scan(z, rw, st)
    th, ts = L.slstm_scan(_t(z), _t(rw),
                          None if st is None else tuple(map(_t, st)))
    _scan_close(th, jh)
    for a, b in zip(ts, js):
        _scan_close(a, b)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_scan_matches_jax(with_state):
    rng = _rng(8)
    B, S, H, hd, N = 2, 300, 3, 8, 4
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    delta = (0.1 * np.abs(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H, hd, N))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal((H, hd)).astype(np.float32)
    st = rng.standard_normal((B, H, hd, N)).astype(np.float32) \
        if with_state else None
    jy, js = JL.mamba_scan(x, delta, A, Bm, Cm, D, state=st)
    given = None if st is None else _t(st)
    ty, ts = L.mamba_scan(*map(_t, (x, delta, A, Bm, Cm, D)), state=given)
    _scan_close(ty, jy)
    _scan_close(ts, js)
    if given is not None:
        assert np.array_equal(given.numpy(), st)


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------

def _key(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


NORMS = ("ln", "ln1", "ln2", "gn", "ssm_ln", "final_norm")


@pytest.fixture(scope="module", params=list(ARCHS))
def weights(request):
    """JAX params with random norm scales (the init leaves them zero), and
    the port's through the flat dict the checkpoint writes."""
    arch = ARCHS[request.param]
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = _rng(1)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        a = np.asarray(jnp.asarray(leaf, jnp.float32))
        if _key(path).split("/")[-1] in NORMS:
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        flat[_key(path)] = a
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(flat[_key(p)], x.dtype), jp)
    tp = M.params_from_numpy(flat, cfg)
    assert _shapes(tp) == _shapes(M.init_params(cfg, 0))
    return request.param, jcfg, cfg, jp, tp


def _shapes(params, pre=""):
    """{key: (shape, dtype)} of a nested params tree."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{pre}{k}/"))
        else:
            out[pre + k] = (tuple(v.shape), v.dtype)
    return out


def _tokens(rng, cfg, B, S):
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _cache_close(tc, jc):
    """Every tensor of the port's cache against the reference's."""
    flat_t = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.numpy(), tc))
    flat_j = jax.tree_util.tree_leaves(jc)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        _close(torch.from_numpy(a), b)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_prefill_matches_jax(weights, with_prefix):
    """A 20-token prefill; with a prefix, on top of a first 30-token one:
    for xLSTM its state, for Hymba its K/V and SSM state, for MusicGen its
    K/V."""
    _, jcfg, cfg, jp, tp = weights
    rng = _rng(10 + with_prefix)
    B = 2
    jpc = tpc = None
    P = 0
    if with_prefix:
        first = _tokens(rng, cfg, B, 30)
        _, jpc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(first)})
        _, tpc = M.prefill(cfg, tp, _t(first).long())
        P = 30
    toks = _tokens(rng, cfg, B, 20)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        prefix_cache=jpc, prefix_len=P)
    tl, tc = M.prefill(cfg, tp, _t(toks).long(), tpc, P)
    assert tuple(tl.shape) == (B, 1) + ((cfg.n_codebooks,)
                                        if cfg.n_codebooks else ()) \
        + (cfg.vocab_size,)
    _close(tl, jl)
    _cache_close(tc, jc)


def test_decode_steps_match_jax(weights):
    """A 24-token prefill, then 4 decode steps, each over the cache the
    previous one left."""
    _, jcfg, cfg, jp, tp = weights
    rng = _rng(12)
    B, P, n = 2, 24, 4
    toks = _tokens(rng, cfg, B, P)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _, tc = M.prefill(cfg, tp, _t(toks).long())
    if cfg.family == "ssm":
        jd, td = jc, tc
    else:
        jd = JM.init_decode_cache(jcfg, B, P + n)
        jd = dict(jd, k=jd["k"].at[:, :, :P].set(jc["k"]),
                  v=jd["v"].at[:, :, :P].set(jc["v"]))
        td = M.init_decode_cache(cfg, B, P + n)
        td["k"][:, :, :P], td["v"][:, :, :P] = tc["k"], tc["v"]
        if cfg.family == "hybrid":
            jd["ssm"], td["ssm"] = jc["ssm"], tc["ssm"]
    pos = np.full((B,), P, np.int32)
    for _ in range(n):
        pos = pos + 1
        tok = _tokens(rng, cfg, B, 1)
        jl, jd = JM.decode_step(jcfg, jp, jnp.asarray(tok), jd,
                                jnp.asarray(pos))
        tl = M.decode_step(cfg, tp, _t(tok).long(), td, _t(pos))
        _close(tl, jl)
    _cache_close(td, jd)


@pytest.mark.parametrize("weights", ["xlstm-reduced", "hymba-reduced"],
                         indirect=True)
def test_steps_never_write_the_state_they_read(weights):
    """A prefill on a prefix and a decode step leave the prefix's state
    tensors as they were: the knowledge tree holds those tensors."""
    _, _, cfg, _, tp = weights
    rng = _rng(13)
    _, pc = M.prefill(cfg, tp, _t(_tokens(rng, cfg, 1, 20)).long())
    state = pc if cfg.family == "ssm" else {"ssm": pc["ssm"]}
    before = _digest(state)
    M.prefill(cfg, tp, _t(_tokens(rng, cfg, 1, 8)).long(), pc, 20)
    dc = dict(pc) if cfg.family == "ssm" else dict(
        M.init_decode_cache(cfg, 1, 21), ssm=pc["ssm"])
    M.decode_step(cfg, tp, _t(_tokens(rng, cfg, 1, 1)).long(), dc,
                  torch.tensor([21], dtype=torch.int32))
    assert _digest(state) == before
    assert _digest(dc) != _digest(pc if cfg.family == "ssm" else state)


def test_params_from_numpy_keeps_the_reference_dtypes():
    """bf16 params load as bf16, but Hymba's ssm_A and ssm_D, f32 in the
    reference (and in the port's own init), stay f32."""
    cfg = get_reduced("hymba-1.5b")
    jp = JM.init_params(jax_reduced("hymba-1.5b"), jax.random.PRNGKey(0))
    flat = {_key(p): np.asarray(jnp.asarray(x, jnp.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = M.params_from_numpy(flat, cfg)
    assert tp["blocks"]["ssm_A"].dtype == torch.float32
    assert tp["blocks"]["ssm_D"].dtype == torch.float32
    assert tp["blocks"]["wq"].dtype == torch.bfloat16
    want = {_key(p): x.dtype for p, x in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {k: str(v[1]).removeprefix("torch.")
           for k, v in _shapes(tp).items()}
    assert got == {k: str(v) for k, v in want.items()}
    assert np.array_equal(tp["blocks"]["ssm_A"].numpy(),
                          np.asarray(jp["blocks"]["ssm_A"]))


def test_full_size_trees_match_the_reference():
    """The published configs' params: the port's tree (shapes and dtypes,
    drawn on the meta device) equals the reference's ``eval_shape``."""
    from repro.configs import get_config as jax_config
    for arch in ARCHS.values():
        want = jax.eval_shape(lambda k: JM.init_params(jax_config(arch), k),
                              jax.random.PRNGKey(0))
        want = {_key(p): (tuple(x.shape), str(x.dtype)) for p, x in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        got = {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in
               _shapes(M.init_params(get_config(arch), 0, "meta")).items()}
        assert got == want, arch


# ---------------------------------------------------------------------------
# the sequential engine
# ---------------------------------------------------------------------------

def _digest(payload) -> str:
    """sha256 over a nested payload's tensors' bytes, in tree order."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif x is not None:
            h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    walk(payload)
    return h.hexdigest()


def _snapshots(tree):
    """{(node id, tier): digest} of every GPU- and host-tier payload."""
    out = {}
    for n in tree.nodes():
        if n is tree.root:
            continue
        if n.in_gpu and n.payload_gpu is not None:
            out[(id(n), "gpu")] = _digest(n.payload_gpu)
        if n.in_host and n.payload_host is not None:
            out[(id(n), "host")] = _digest(n.payload_host)
    return out


@pytest.fixture(scope="module", params=["xlstm-reduced", "hymba-reduced"])
def setup(request):
    name = request.param
    arch = ARCHS[name]
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {_key(p): np.asarray(jnp.asarray(x, jnp.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = M.params_from_numpy(flat, cfg)
    kw = dict(mean_doc_tokens=32, vocab=cfg.vocab_size, seed=0)
    jcorpus, corpus = jax_corpus(N_DOCS, **kw), make_corpus(N_DOCS, **kw)
    # segments under ~100 tokens keep the reference's chunkwise mLSTM
    # finite (see the module docstring)
    assert max(corpus.doc_lengths) < 100
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=4, nprobe=2)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=4, nprobe=2)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    kw = dict(n_requests=N_REQ, rate=100.0, question_tokens=8,
              vocab=cfg.vocab_size, zipf_s=1.2, seed=1)
    conf = dict(top_k=2, gpu_cache_bytes=GPU_TIER[name],
                host_cache_bytes=1 << 30)
    srv = RAGServer(cfg, tp, corpus, idx, config=EngineConfig(**conf),
                    device="cpu")
    wl = make_workload(corpus, **kw)

    def serve_all():
        return sorted(srv.serve(wl, max_new_tokens=NEW),
                      key=lambda r: r.req_id)

    # cold, then the same requests again with every doc cached
    cold = serve_all()
    before, loads = _snapshots(srv.tree), srv.tree.stats["load_bytes"]
    warm = serve_all()
    return dict(name=name, jcfg=jcfg, cfg=cfg, jp=jp, tp=tp,
                jcorpus=jcorpus, corpus=corpus, jidx=jidx, idx=idx,
                jwl=jax_workload(jcorpus, **kw), wl=wl, conf=conf, srv=srv,
                cold=cold, warm=warm, before=before, loads=loads,
                after=_snapshots(srv.tree))


def test_rag_server_matches_jax(setup):
    """Tokens and first-token logits against the reference's RAGServer on
    the same corpus, index, workload and tiers, cold and then warm; both
    trees make the same moves, snapshots swapped to the host tier and
    promoted back among them."""
    s = setup
    jsrv = JaxRAGServer(s["jcfg"], s["jp"], s["jcorpus"], s["jidx"],
                        config=JaxEngineConfig(**s["conf"]))
    for got in (s["cold"], s["warm"]):
        want = sorted(jsrv.serve(s["jwl"], max_new_tokens=NEW),
                      key=lambda r: r.req_id)
        assert [r.req_id for r in got] == [r.req_id for r in want]
        for a, b in zip(got, want):
            assert a.docs == tuple(b.docs)
            assert (a.alpha, a.beta) == (b.alpha, b.beta)
            assert a.tokens == list(b.tokens), (a.req_id, a.tokens, b.tokens)
            err = float(np.max(np.abs(a.first_logits - np.asarray(
                b.first_logits))))
            assert err <= EPS, (a.req_id, err)
    stats = s["srv"].tree.stats
    assert stats == {k: (v if "seconds" not in k else stats[k])
                     for k, v in jsrv.tree.stats.items()}
    assert stats["swap_out_bytes"] > 0 and stats["load_bytes"] > 0


def test_warm_hits_give_the_cold_bits(setup):
    """The cold requests served again on the same server: every doc is a
    tree hit (one through the host tier), the tokens and first-token logits
    are bit-identical, and no snapshot the tree held changed."""
    s = setup
    assert any(tier == "host" for _, tier in s["before"])
    assert s["srv"].tree.stats["load_bytes"] > s["loads"]
    questions = {r.req_id: len(r.question_tokens) for r in s["wl"]}
    for a, b in zip(s["warm"], s["cold"]):
        assert a.alpha == b.alpha + b.beta - questions[a.req_id]
        assert a.tokens == b.tokens
        assert np.array_equal(a.first_logits, b.first_logits)
    common = s["before"].keys() & s["after"].keys()
    assert common and all(s["before"][k] == s["after"][k] for k in common)


def test_host_tier_payload_is_a_nested_copy(setup):
    """The host tier holds CPU copies of the whole nested payload."""
    srv = setup["srv"]
    host = [n for n in srv.tree.nodes() if n.in_host]
    assert host
    for n in host:
        assert _digest(n.payload_host) == _digest(
            n.payload_gpu if n.payload_gpu is not None else n.payload_host)


def test_continuous_runtime_refuses_recurrent_families(setup):
    s = setup
    with pytest.raises(ValueError, match="paged"):
        ContinuousRuntime(s["cfg"], s["tp"], s["corpus"], s["idx"],
                          config=EngineConfig(), device="cpu")


def test_cag_raises_as_the_reference_does(setup):
    s = setup
    conf = dict(mode="cag", disk_cache_bytes=1 << 20)
    with pytest.raises(ValueError) as theirs:
        JaxRAGServer(s["jcfg"], s["jp"], s["jcorpus"], s["jidx"],
                     config=JaxEngineConfig(**conf))
    with pytest.raises(ValueError) as ours:
        RAGServer(s["cfg"], s["tp"], s["corpus"], s["idx"],
                  config=EngineConfig(**conf), device="cpu")
    assert str(ours.value) == str(theirs.value)
    assert "no disk tier" in str(ours.value)


# ---------------------------------------------------------------------------
# serve.main
# ---------------------------------------------------------------------------

ARGV = ["--requests", "3", "--docs", "8", "--doc-tokens", "32",
        "--max-new-tokens", "2", "--check-tokens", "--replicas", "2",
        "--frontdoor"]


def _notes(text):
    return [line for line in text.splitlines() if line.startswith("note:")]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_serve_main_prints_the_reference_notes(arch, capsys, monkeypatch):
    """Recurrent families go to the sequential engine; --check-tokens,
    --frontdoor and --replicas say they do not apply, as the reference's
    serve.main says (its notes come before it serves, which is skipped
    here)."""
    served = []
    monkeypatch.setattr(jax_serve, "serve_sequential",
                        lambda *a, **k: served.append(len(a[4])))
    jax_serve_main(["--arch", arch] + ARGV)
    want = _notes(capsys.readouterr().out)
    assert served == [3]
    serve.main(["--device", "cpu", "--arch", arch] + ARGV)
    out = capsys.readouterr().out
    assert _notes(out) == want and len(want) == 4
    assert "[sequential] served 3 requests" in out
    assert "token check" not in out


def jax_serve_main(argv):
    import sys
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        jax_serve.main()
    finally:
        sys.argv = saved


def test_serve_main_tp_note_for_recurrent(capsys):
    """--tp applies to the continuous engine only: a recurrent family is
    served by the sequential engine, with the reference's note."""
    serve.main(["--device", "cpu", "--arch", "xlstm-1.3b", "--tp", "2",
                "--requests", "2", "--docs", "8", "--max-new-tokens", "1"])
    assert "note: --tp applies to the continuous engine only" in \
        capsys.readouterr().out


@pytest.mark.parametrize("sequential", [False, True])
def test_serve_main_refuses_musicgen_as_the_reference_does(sequential):
    """No reference engine serves the audio family: its requests are (B, S)
    token rows, its model takes (B, K, S), and both serve.mains raise
    ValueError."""
    argv = ["--arch", "musicgen-large", "--requests", "2", "--docs", "8",
            "--max-new-tokens", "1"] + (["--sequential"] if sequential
                                        else [])
    with pytest.raises(ValueError):
        jax_serve_main(argv)
    with pytest.raises(ValueError, match="codebook"):
        serve.main(["--device", "cpu"] + argv)
