"""The MoE and VLM families in the port, on the CPU in f32, against the
JAX package on the same params (carried across through
``params_from_numpy``): Mixtral-8x7B's reduced config (4 experts, top 2, a
64-token window on every layer), Phi-3.5-MoE's (4 experts, top 2) and
InternVL2-1B's (the dense backbone with a projected patch prefix).

Layers: ``moe_dense`` and ``moe_capacity`` within 1e-5 of JAX's, also
where router logits tie (the lower expert index wins on both sides), and
capacity equal to dense where no token drops.  Model steps: logits and
caches within 1e-5.  Runtime: tokens equal and first-token logits within
1e-4 of JAX's.  Inside the port the exact claims hold: chunked prefill
gives the unchunked tokens, the continuous runtime the sequential
engine's.  The dense families' seeded init is pinned by checksum: the MoE
and VLM params did not move their streams.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.retrieval.corpus import make_corpus as jax_corpus
from repro.retrieval.corpus import make_workload as jax_workload
from repro.retrieval.vectordb import IVFIndex as JaxIVF
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.runtime import ContinuousRuntime as JaxRuntime
from repro_torch.configs import get_reduced
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

EPS = 1e-4
STEP_EPS = 1e-5
PAGE, SCRATCH = 16, 0
N_REQ, N_DOCS, NEW = 4, 12, 3
# reduced config name -> architecture
ARCHS = {"mixtral-reduced": "mixtral-8x7b",
         "phi35-moe-reduced": "phi3.5-moe-42b-a6.6b",
         "internvl2-reduced": "internvl2-1b"}
NAMES = list(ARCHS)
# sha256 over (key, bf16 bits) of init_params(get_reduced(arch), 0), keys
# sorted, recorded before the MoE and VLM params joined the init
INIT_PINS = {
    "qwen2-0.5b":
        "904935cfaf5516f261edc70519cd1331d69be5361720063f949a6ad9219c3098",
    "mistral-7b":
        "ff70fe2e8cbd541f87ae1f435a7a0b8fac9402a0a1a28926d9c3fa4cf7978d31",
}


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


def _digest(params) -> str:
    h = hashlib.sha256()

    def walk(d, pre):
        for k in sorted(d):
            if isinstance(d[k], dict):
                walk(d[k], f"{pre}{k}/")
            else:
                h.update(f"{pre}{k}".encode())
                h.update(d[k].contiguous().view(torch.int16).numpy()
                         .tobytes())
    walk(params, "")
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(INIT_PINS))
def test_dense_init_streams_are_pinned(arch):
    assert _digest(M.init_params(get_reduced(arch), 0)) == INIT_PINS[arch]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _moe_inputs(seed, B=2, S=24, D=32, E=4, F=48, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    router = (0.5 * rng.standard_normal((D, E))).astype(np.float32)
    if tie:
        # experts 1-3 share one router column: their logits tie on every
        # row, and rows that prefer them tie three ways for two picks
        router[:, 2] = router[:, 3] = router[:, 1]
    ws = [(0.1 * rng.standard_normal(s)).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    return [x, router] + ws


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("impl", ["moe_dense", "moe_capacity"])
def test_moe_layer_matches_jax(impl, tie):
    ins = _moe_inputs(3, tie=tie)
    want = getattr(JL, impl)(*map(_j, ins), top_k=2)
    got = getattr(L, impl)(*map(_t, ins), top_k=2)
    _close(got, want)
    if tie:
        logits = L.proj(_t(ins[0]), _t(ins[1])).float()
        assert bool((logits[..., 1] == logits[..., 3]).all())
        _, topi = L.stable_top_k(logits, 2)
        _, jtopi = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
        assert np.array_equal(np.asarray(jtopi), topi.numpy())
        assert not (topi == 3).any()
        assert ((topi[..., 0] == 1) & (topi[..., 1] == 2)).any()


def test_moe_capacity_approximates_dense():
    """With generous capacity no token drops: capacity == dense routing
    (the JAX package's test_layers case, on the port)."""
    rng = np.random.default_rng(7)
    B, S, D, E, F = 2, 16, 32, 4, 64
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    router = torch.from_numpy(
        (0.5 * rng.standard_normal((D, E))).astype(np.float32))
    wg, wu = (torch.from_numpy((0.1 * rng.standard_normal((E, D, F)))
                               .astype(np.float32)) for _ in range(2))
    wd = torch.from_numpy((0.1 * rng.standard_normal((E, F, D)))
                          .astype(np.float32))
    y1 = L.moe_dense(x, router, wg, wu, wd, top_k=2)
    y2 = L.moe_capacity(x, router, wg, wu, wd, top_k=2,
                        capacity_factor=4.0, token_chunk=32)
    assert float((y1 - y2).abs().max()) <= 1e-4


def test_capacity_drops_past_the_buffer():
    """Most tokens prefer expert 0: its buffer keeps the first ``cap``
    tokens in order and drops the rest, as JAX's does."""
    ins = _moe_inputs(4, S=40)
    c = np.full(32, 32 ** -0.5, np.float32)
    ins[0] += 3.0 * c
    ins[1][:, 0] = 4.0 * c
    want = JL.moe_capacity(*map(_j, ins), top_k=2, capacity_factor=1.0,
                           token_chunk=40)
    got = L.moe_capacity(*map(_t, ins), top_k=2, capacity_factor=1.0,
                         token_chunk=40)
    _close(got, want)
    gates, topi = L.route(_t(ins[0]).reshape(-1, 32), _t(ins[1]), 2)
    _, _, keep = L.capacity_slots(topi[:40], 4, 20)
    assert int(keep[..., 0].sum()) == 20 < int((topi[:40] == 0).sum())


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------

def _key(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


@pytest.fixture(scope="module", params=NAMES)
def weights(request):
    """JAX params with random norm scales (the init leaves them zero), and
    the port's through the flat dict the checkpoint writes."""
    arch = ARCHS[request.param]
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
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
    tp = M.params_from_numpy(flat, cfg)
    assert _shapes(tp) == _shapes(M.init_params(cfg, 0))
    return request.param, jcfg, cfg, jp, tp


def _shapes(params):
    """{key: shape} of the params tree."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": tuple(vv.shape) for kk, vv in v.items()})
        else:
            out[k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("prefix_len", [0, 70])
def test_prefill_matches_jax(weights, prefix_len):
    _, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(prefix_len)
    B, S = 2, 20
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


@pytest.mark.parametrize("weights", ["internvl2-reduced"], indirect=True)
def test_vlm_prefill_with_patch_embeds(weights):
    """The projected patches ahead of the tokens: the cache covers both,
    and the logits follow the patches (they differ from text only)."""
    name, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(9)
    B, S, P = 2, 12, cfg.vision_tokens
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pe = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": _j(toks),
                                   "patch_embeds": _j(pe)})
    tl, tc = M.prefill(cfg, tp, _t(toks).long(), patch_embeds=_t(pe))
    assert tc["k"].shape[2] == P + S
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    text, _ = M.prefill(cfg, tp, _t(toks).long())
    assert float((text - tl).abs().max()) > 1e-3


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


def _pool_close(tk, jk):
    # block 0 is the scratch block: padding rows write it in no set order
    a = tk.float().numpy()[:, 1:]
    b = np.asarray(jnp.asarray(jk, jnp.float32))[:, 1:]
    assert np.max(np.abs(a - b)) <= STEP_EPS


def test_paged_steps_match_jax(weights):
    """A ragged prefill (row 0 on 70 cached tokens, past the reduced
    Mixtral window; row 1 fresh), then a decode step for both rows and a
    dummy row on top of it."""
    _, jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(2)
    n_blocks, B, Sq, T = 14, 2, 32, 10
    shape = (cfg.n_layers, n_blocks, PAGE, cfg.n_kv_heads, cfg.hd)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.full((B, T), SCRATCH, np.int32)
    counts = np.zeros((B, T), np.int32)
    starts = np.zeros((B, T), np.int32)
    wblk = np.full((B, Sq), SCRATCH, np.int32)
    wslot = np.zeros((B, Sq), np.int32)
    tables[0, :5] = [free.pop() for _ in range(5)]
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
    ins = (tables, counts, starts, np.array([70, 0], np.int32),
           np.array([20, 9], np.int32), wblk, wslot)
    jl, jk, jv = JM.paged_prefill_step(jcfg, jp, _j(toks), _j(kp), _j(vp),
                                       *map(_j, ins), attn_impl="jnp")
    tk, tv = _t(kp), _t(vp)
    tl = M.paged_prefill_step(cfg, tp, _t(toks).long(), [tk], [tv],
                              *map(_t, ins))
    _close(tl, jl)
    _pool_close(tk, jk)
    _pool_close(tv, jv)

    dt = np.full((3, T), SCRATCH, np.int32)
    dc = np.zeros((3, T), np.int32)
    ds = np.zeros((3, T), np.int32)
    dt[:2], dc[:2], ds[:2] = tables, counts, starts
    dc[0, 6] += 1
    dc[1, 0] += 1
    dc[2, 0] = 1
    pos = np.array([91, 10, 1], np.int32)
    wb = np.array([new0[1], new1, SCRATCH], np.int32)
    ws = np.array([4, 9, 0], np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jl2, jk2, jv2 = JM.paged_decode_step(
        jcfg, jp, _j(dtok), jk, jv, _j(dt), _j(dc), _j(ds), _j(wb), _j(ws),
        _j(pos), attn_impl="jnp")
    tl2 = M.paged_decode_step(cfg, tp, _t(dtok).long(), [tk], [tv], _t(dt),
                              _t(dc), _t(ds), _t(wb), _t(ws), _t(pos))
    _close(tl2, jl2)
    _pool_close(tk, jk2)
    _pool_close(tv, jv2)


@pytest.mark.parametrize("weights", ["mixtral-reduced", "phi35-moe-reduced"],
                         indirect=True)
def test_capacity_impl_model_step_matches_jax(weights):
    """``moe_impl="capacity"`` through the whole prefill."""
    _, jcfg, cfg, jp, tp = weights
    jcfg = dataclasses.replace(jcfg, moe_impl="capacity")
    cfg = dataclasses.replace(cfg, moe_impl="capacity")
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": _j(toks)})
    tl, tc = M.prefill(cfg, tp, _t(toks).long())
    _close(tl, jl)
    _close(tc["k"], jc["k"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(weights):
    name, jcfg, cfg, jp, tp = weights
    kw = dict(mean_doc_tokens=40, vocab=cfg.vocab_size, seed=0)
    jcorpus, corpus = jax_corpus(N_DOCS, **kw), make_corpus(N_DOCS, **kw)
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=6, nprobe=3)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=6, nprobe=3)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    kw = dict(n_requests=N_REQ, rate=100.0, question_tokens=8,
              vocab=cfg.vocab_size, zipf_s=1.2, seed=1)
    return dict(name=name, jcfg=jcfg, cfg=cfg, jp=jp, params=tp,
                jcorpus=jcorpus, corpus=corpus, jidx=jidx, idx=idx,
                jwl=jax_workload(jcorpus, **kw),
                wl=make_workload(corpus, **kw))


def _port_serve(s, **conf):
    rt = ContinuousRuntime(s["cfg"], s["params"], s["corpus"], s["idx"],
                           config=EngineConfig(top_k=2, **conf),
                           device="cpu")
    return sorted(rt.serve(s["wl"], max_new_tokens=NEW),
                  key=lambda r: r.req_id)


@pytest.fixture(scope="module")
def port_run(setup):
    return _port_serve(setup)


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


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


def test_chunked_prefill_gives_the_same_tokens(setup, port_run):
    chunked = _port_serve(setup, prefill_chunk=7)
    assert [r.tokens for r in chunked] == [r.tokens for r in port_run]
    assert all(np.array_equal(a.first_logits, b.first_logits)
               for a, b in zip(chunked, port_run))


def test_continuous_gives_the_sequential_tokens(setup, port_run):
    s = setup
    srv = RAGServer(s["cfg"], s["params"], s["corpus"], s["idx"],
                    config=EngineConfig(top_k=2), device="cpu")
    seq = sorted(srv.serve(s["wl"], max_new_tokens=NEW),
                 key=lambda r: r.req_id)
    assert serve.token_mismatches(zip(port_run, seq), "exact", 0.0) == []
    assert max(_linf(a.first_logits, b.first_logits)
               for a, b in zip(port_run, seq)) <= EPS


def test_serve_main_serves_the_arch(setup, capsys):
    """serve.main --arch on the CPU at reduced size, bf16, --check-tokens
    exact."""
    arch = ARCHS[setup["name"]]
    serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                "--docs", "8", "--doc-tokens", "32", "--max-new-tokens",
                "2", "--max-batch", "2", "--check-tokens", "exact"])
    out = capsys.readouterr().out
    assert f"model={setup['name']} family={setup['cfg'].family}" in out
    assert "token check: all 3 requests identical" in out


@pytest.mark.parametrize("change", [dict(family="encdec"),
                                    dict(family="diffusion"),
                                    dict(family="retnet", n_codebooks=4)])
def test_unported_families_raise(change):
    """Every family of the JAX package is ported (the recurrent and audio
    ones in tests/test_torch_recurrent.py); any other raises."""
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), **change)
    with pytest.raises(NotImplementedError, match="not ported"):
        M.init_params(cfg, 0)


# products layers.slabbed runs in fixed row slabs at each MoE model's
# widths.  On the card (chip_smoke.py's probe, Mixtral-8x7B) k and every
# expert's down projection were row-variant without the slabs; the router
# (N 8) was not, and is slabbed all the same (a 512 x 4096 x 8 product).
# Phi-3.5-MoE's probe (phase phi) found k, v and each expert's gate and up
# (K 4096, N 6400) row-variant without the slabs, and its down (K 6400),
# router (N 16), q, o and logits not: the depth rule missed gate and up,
# so layers.SLAB_WIDTHS adds their (K, N) and Phi's set gains them.
SLABBED = {"mixtral-8x7b": {"k", "v", "down", "router"},
           "phi3.5-moe-42b-a6.6b": {"k", "v", "gate", "up", "down",
                                    "router"}}


@pytest.mark.parametrize("arch", sorted(SLABBED))
def test_slab_rule_at_moe_widths(arch):
    from repro_torch.configs import get_config
    c = get_config(arch)
    D, F, H, KV, hd = c.d_model, c.d_ff, c.n_heads, c.n_kv_heads, c.hd
    shapes = {"q": (D, H * hd), "k": (D, KV * hd), "v": (D, KV * hd),
              "o": (H * hd, D), "gate": (D, F), "up": (D, F),
              "down": (F, D), "router": (D, c.moe_experts),
              "logits": (D, c.vocab_size)}
    got = {name for name, shape in shapes.items()
           if L.slabbed(torch.empty(shape, device="meta"))}
    assert got == SLABBED[arch]
