"""Tensor-parallel serving of the port on the CPU, with tp CPU shards
(``launch/mesh.py::make_serving_mesh(tp, device="cpu")``).

Twins of the reference's TP tests (``tests/test_tp_serving.py``, the
``--prefill-chunk 6 --tp 2`` case of ``tests/test_serve_main.py`` and the
``--mode cag --tp 2`` case of ``tests/test_cag_mode.py``), which skip
there without forced host devices, run here on CPU shards.  Against JAX:
the port's tp 2 and tp 4 give the tokens of JAX's tp 1, first-token logits
within 1e-4.  Within the port: tp 2, 4 and 8 give the tokens, tier hits
and first-token logits of tp 1 over a one-device mesh of the same
column-slab group (``launch/mesh.py``) bit for bit, in f32 and bf16,
through the paged and dense engines, chunked prefill, chunk reuse, CAG and
the host tier's swaps (``ShardedPagedBackend``).  A runtime keeps only its
shards, and the split draw gives the shards of the whole tree.
"""

import gc
import weakref

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
from repro.models import model as JM
from repro.retrieval.corpus import make_corpus as jax_corpus
from repro.retrieval.corpus import make_workload as jax_workload
from repro.retrieval.vectordb import IVFIndex as JaxIVF
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.runtime import ContinuousRuntime as JaxRuntime
from repro_torch.configs import get_reduced
from repro_torch.core.knowledge_tree import EvictionError
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import paged_prefill as PP
from repro_torch.launch import serve
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.sharding import assert_tp_compatible, kv_heads_shardable
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig, MeshConfig
from repro_torch.serving.runtime import ContinuousRuntime, ShardedPagedBackend

# both runtimes on one constant clock for the module (test_torch_clock.py)
from test_torch_clock import constant_clock  # noqa: F401

EPS = 1e-4
TINY = [
    "--device",
    "cpu",
    "--requests",
    "4",
    "--docs",
    "8",
    "--doc-tokens",
    "10",
    "--top-k",
    "2",
    "--max-new-tokens",
    "2",
    "--rate",
    "100",
]
STATS = ("hit_tokens_gpu", "hit_tokens_host", "hit_tokens_disk", "hits", "misses")


def _main(capsys, extra):
    serve.main(TINY + extra)
    return capsys.readouterr().out


# ---------------------------------------------------------------------------
# twins of tests/test_tp_serving.py
# ---------------------------------------------------------------------------


def test_tp_head_divisibility_errors_before_device_work(monkeypatch):
    """qwen2-reduced has 2 KV heads: --tp 4 fails with the reference's
    one-line SystemExit before any weight is drawn or mesh built."""

    def no_device_work(*a, **kw):
        raise AssertionError("device work before the head check")

    monkeypatch.setattr(serve, "make_setup", no_device_work)
    monkeypatch.setattr(serve, "make_serving_mesh", no_device_work)
    with pytest.raises(SystemExit) as e:
        serve.main(TINY + ["--tp", "4"])
    msg = str(e.value)
    assert "shard a KV head" in msg and "--tp 4" in msg
    assert "[1, 2]" in msg


def test_kv_heads_shardable_table():
    qwen = get_reduced("qwen2-0.5b")  # H=4, KV=2
    llama = get_reduced("llama2-7b")  # H=4, KV=4
    assert [t for t in (1, 2, 4) if kv_heads_shardable(qwen, t)] == [1, 2]
    assert [t for t in (1, 2, 4) if kv_heads_shardable(llama, t)] == [1, 2, 4]
    assert_tp_compatible(llama, 4)
    with pytest.raises(ValueError):
        assert_tp_compatible(qwen, 4)


def test_tp2_check_tokens(capsys):
    out = _main(capsys, ["--tp", "2", "--check-tokens"])
    assert "tensor parallel: tp=2 over a (1, 2) mesh" in out
    assert "partition specs over model=2" in out
    assert "token check: all 4 requests identical" in out


def test_tp4_check_tokens_llama(capsys):
    out = _main(capsys, ["--arch", "llama2-7b", "--tp", "4", "--check-tokens"])
    assert "tensor parallel: tp=4" in out
    assert "token check: all 4 requests identical" in out


def test_2d_fleet_replicas_x_tp(capsys):
    out = _main(capsys, ["--tp", "2", "--replicas", "2", "--check-tokens"])
    assert "continuous x2 (affinity)" in out
    assert "token check: all 4 requests identical" in out


def test_mesh_size_parity_tokens_and_tier_hits():
    """Mesh sizes 1 / 2 / 4 of one column-slab group: the same tokens,
    per-tier hit attribution and first-token logits bits."""
    args = serve.build_parser().parse_args(
        TINY + ["--arch", "llama2-7b", "--requests", "6"]
    )
    cfg, params, corpus, idx, wl, _ = serve.make_setup(args)
    runs = {}
    for tp in (1, 2, 4):
        args.tp = tp
        rt = ContinuousRuntime(
            cfg,
            params,
            corpus,
            idx,
            config=EngineConfig.from_args(args),
            device="cpu",
            mesh=make_serving_mesh(tp, device="cpu", slabs=4),
        )
        res = sorted(rt.serve(wl, max_new_tokens=2), key=lambda r: r.req_id)
        s = rt.tree.stats
        runs[tp] = (
            [list(r.tokens) for r in res],
            {k: s[k] for k in STATS},
            [r.first_logits for r in res],
        )
    for tp in (2, 4):
        assert runs[tp][:2] == runs[1][:2]
        assert all(map(np.array_equal, runs[tp][2], runs[1][2]))


def test_tp2_chunk_reuse_tolerance(capsys):
    out = _main(
        capsys,
        [
            "--tp",
            "2",
            "--attn",
            "paged",
            "--reuse",
            "chunk",
            "--recompute-tokens",
            "8",
            "--block-size",
            "8",
            "--check-tokens",
            "tol:5",
        ],
    )
    assert "tensor parallel: tp=2" in out
    assert "token check: all 4 requests within tol 5" in out


def test_tp_with_paged_disk_tiers(capsys):
    out = _main(
        capsys,
        [
            "--tp",
            "2",
            "--check-tokens",
            "--gpu-cache-bytes",
            str(48 * 2**10),
            "--disk-cache-bytes",
            str(8 * 2**20),
        ],
    )
    assert "token check: all 4 requests identical" in out
    assert "'swap_out_bytes': 0," not in out


def test_main_check_tokens_paged_prefill_tp2(capsys):
    """The twin of test_serve_main.py's --prefill-chunk 6 --tp 2."""
    out = _main(
        capsys,
        ["--check-tokens", "--attn", "paged", "--prefill-chunk", "6", "--tp", "2"],
    )
    assert "token check: all 4 requests identical" in out


def test_main_cag_check_tokens_tp2(capsys):
    """The twin of test_cag_mode.py's --mode cag --tp 2: the preload runs
    over the mesh, the sharded pool splits the promoted copies."""
    out = _main(
        capsys, ["--mode", "cag", "--check-tokens", "--attn", "paged", "--tp", "2"]
    )
    assert "[cag] preloaded 8 docs" in out
    assert "token check: all 4 requests identical" in out


def test_moe_under_tp_is_refused(capsys):
    """The MoE family serves under --tp (tests/test_torch_tp_moe.py holds
    its bits); what stays refused under a mesh is the recurrent and audio
    families, whose model steps raise before any product."""
    out = _main(capsys, ["--arch", "mixtral-8x7b", "--tp", "2"])
    assert "tensor parallel: tp=2" in out
    mesh = make_serving_mesh(2, device="cpu")
    for arch in ("hymba-1.5b", "xlstm-1.3b", "musicgen-large"):
        cfg = get_reduced(arch)
        with pytest.raises(NotImplementedError, match="under a mesh"):
            sh.placer(cfg, mesh)
        with pytest.raises(NotImplementedError, match="under a mesh"):
            M.decode_step(cfg, [{}, {}], None, None, None, mesh=mesh)


# ---------------------------------------------------------------------------
# within the port: tp N against tp 1, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in ("qwen2-0.5b", "llama2-7b", "mistral-7b"):
        for dtype in ("float32", "bfloat16"):
            args = serve.build_parser().parse_args(
                TINY + ["--arch", arch, "--requests", "6", "--doc-tokens", "20"]
            )
            cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
            out[arch, dtype] = serve.make_setup(args, cfg=cfg)[:5]
    return out


def _serve(setup, tp, slabs=0, **conf):
    """Serve the setup at ``tp`` CPU shards, the mesh's column-slab group
    ``slabs`` (0: tp)."""
    cfg, params, corpus, idx, wl = setup
    config = EngineConfig(top_k=2, mesh=MeshConfig(tp=tp), **conf)
    mesh = make_serving_mesh(tp, device="cpu", slabs=slabs)
    rt = ContinuousRuntime(
        cfg, params, corpus, idx, config=config, device="cpu", mesh=mesh
    )
    res = sorted(rt.serve(wl, max_new_tokens=3), key=lambda r: r.req_id)
    return rt, res


def _same(a, b):
    (rt_a, res_a), (rt_b, res_b) = a, b
    assert [r.req_id for r in res_a] == [r.req_id for r in res_b]
    assert [r.tokens for r in res_a] == [r.tokens for r in res_b]
    assert {k: rt_a.tree.stats[k] for k in STATS} == {
        k: rt_b.tree.stats[k] for k in STATS
    }
    for x, y in zip(res_a, res_b):
        assert np.array_equal(x.first_logits, y.first_logits), x.req_id


CASES = [
    ("qwen2-0.5b", 2, {}),
    ("llama2-7b", 2, {}),
    ("llama2-7b", 4, {}),
    ("mistral-7b", 2, {}),
    ("llama2-7b", 4, {"attn": "dense"}),
    ("llama2-7b", 4, {"prefill_chunk": 5}),
    ("qwen2-0.5b", 2, {"max_prefill_tokens": 48, "prefill_chunk": 8}),
    ("llama2-7b", 4, {"reuse": "chunk", "block_size": 8, "recompute_tokens": 8}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,tp,conf", CASES)
def test_tp_is_bit_identical_to_tp1(setups, arch, tp, conf, dtype):
    setup = setups[arch, dtype]
    _same(_serve(setup, tp, **conf), _serve(setup, 1, slabs=tp, **conf))


def test_cag_tp_is_bit_identical_to_tp1(setups):
    setup = setups["llama2-7b", "bfloat16"]
    conf = dict(mode="cag", disk_cache_bytes=8 * 2**20)
    for tp in (2, 4):
        _same(_serve(setup, tp, **conf), _serve(setup, 1, slabs=tp, **conf))


def _demote_all(rt):
    """Demote every GPU node of the tree to the host tier."""
    try:
        rt.tree.evict_gpu_until(lambda: False)
    except EvictionError:
        pass


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_backend_swaps_keep_the_bits(setups, dtype):
    """Every cached node demoted through ShardedPagedBackend (each shard's
    head slice pulled into one host copy), then the same requests again,
    promoting from the host tier (store.put splitting the host copies):
    host copies, tokens, tier hits and logits equal tp 1's."""
    setup = setups["llama2-7b", dtype]
    cfg, params, corpus, idx, wl = setup
    runs = {}
    for tp in (1, 2, 4):
        rt, first = _serve(setup, tp, slabs=4)
        assert isinstance(rt.tree.backend, ShardedPagedBackend) == (tp > 1)
        _demote_all(rt)
        host = {
            n.path(): (n.payload_host["k"], n.payload_host["v"])
            for n in rt.tree.nodes()
            if n.payload_host is not None
        }
        again = [dataclasses.replace(r, req_id=r.req_id + 100) for r in wl]
        second = sorted(rt.serve(again, max_new_tokens=3), key=lambda r: r.req_id)
        runs[tp] = (rt, first + second, host)
    assert runs[1][0].tree.stats["load_bytes"] > 0
    assert runs[1][0].tree.stats["hit_tokens_host"] > 0
    for tp in (2, 4):
        _same(runs[tp][:2], runs[1][:2])
        host, want = runs[tp][2], runs[1][2]
        assert host.keys() == want.keys() and host
        for path in want:
            for got, ref in zip(host[path], want[path]):
                assert torch.equal(got, ref), path


def test_paged_kernel_calls_scale_with_tp(setups):
    """Each paged attention call of a step runs once per shard: the plain
    versions' calls at tp N are N times tp 1's (on the card chip_smoke.py
    counts the kernels' launches the same way)."""
    setup = setups["llama2-7b", "float32"]
    counts = {}
    for tp in (1, 2, 4):
        PA.paged_decode_torch.calls = PP.paged_prefill_torch.calls = 0
        _serve(setup, tp)
        counts[tp] = (PA.paged_decode_torch.calls, PP.paged_prefill_torch.calls)
    assert min(counts[1]) > 0
    for tp in (2, 4):
        assert counts[tp] == tuple(tp * n for n in counts[1])


def test_serve_main_replicas_share_the_first_devices(setups):
    """--replicas 2 --tp 2: each replica builds its own mesh over the same
    first two devices; its split leaves are its own copies of the caller's
    columns, its whole leaves the caller's tensors."""
    cfg, params, corpus, idx, _ = setups["qwen2-0.5b", "float32"]
    args = serve.build_parser().parse_args(TINY + ["--tp", "2", "--replicas", "2"])
    rts = serve.make_runtimes(cfg, params, corpus, idx, args, 2)
    for rt in rts:
        assert rt._mesh.devices == (torch.device("cpu"),) * 2
        shard0, shard1 = rt.params
        assert shard0["blocks"]["wo"] is shard1["blocks"]["wo"]
        assert shard0["blocks"]["wo"] is params["blocks"]["wo"]
        wq = params["blocks"]["wq"]
        assert torch.equal(
            torch.cat([shard0["blocks"]["wq"], shard1["blocks"]["wq"]], -1), wq
        )
        assert shard1["blocks"]["wq"].data_ptr() != wq.data_ptr()
    assert rts[0].store.k_planes[0].data_ptr() != rts[1].store.k_planes[0].data_ptr()
    wq0 = [rt.params[0]["blocks"]["wq"].data_ptr() for rt in rts]
    assert wq0[0] != wq0[1]


def test_tp8_is_bit_identical_to_tp1():
    """tp 8, the reference's hint for LLaMA2-70B (64 / 8 heads), on a
    reduced LLaMA2-70B with 8 / 8 heads: tp 1's bits of the same group."""
    args = serve.build_parser().parse_args(
        TINY + ["--arch", "llama2-70b", "--requests", "4", "--doc-tokens", "20"]
    )
    cfg = dataclasses.replace(get_reduced("llama2-70b"), n_heads=8, n_kv_heads=8)
    assert sh._clean_tps(cfg) == [1, 2, 4, 8]
    setup = serve.make_setup(args, cfg=cfg)[:5]
    _same(_serve(setup, 8), _serve(setup, 1, slabs=8))


@pytest.mark.parametrize("mode", ["paged", "cag"])
def test_runtime_holds_only_its_shards(mode):
    """After set-up a tp-2 runtime keeps no whole split leaf alive (in CAG
    mode too); shard 0 holds the whole leaves and its half of the split
    ones, shard 1 the other half, nothing twice."""
    args = serve.build_parser().parse_args(TINY + ["--arch", "llama2-7b"])
    cfg, params, corpus, idx, _, _ = serve.make_setup(args)
    conf = dict(mode="cag", disk_cache_bytes=8 * 2**20) if mode == "cag" else {}
    config = EngineConfig(top_k=2, mesh=MeshConfig(tp=2), **conf)
    whole = {n: weakref.ref(params["blocks"][n]) for n in ("wq", "wg")}
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=config, device="cpu")
    mesh = make_serving_mesh(2, device="cpu")
    want = [0, 0]
    for path, t in sh._leaves(params):
        n = t.numel() * t.element_size()
        if sh._shard_dim(path, t, cfg, mesh) >= 0:
            want = [w + n // 2 for w in want]
        else:
            want[0] += n
    del params
    gc.collect()
    assert all(ref() is None for ref in whole.values())
    seen = set()
    held = []
    for shard in rt.params:
        n = 0
        for _, t in sh._leaves(shard):
            if t.untyped_storage().data_ptr() not in seen:
                seen.add(t.untyped_storage().data_ptr())
                n += t.untyped_storage().nbytes()
        held.append(n)
    assert held == want


def test_split_draw_equals_the_sharded_tree():
    """make_setup over a mesh draws each leaf and splits it at once
    (init_params(place=)): the shards equal shard_params of the whole
    draw, bit for bit."""
    args = serve.build_parser().parse_args(TINY + ["--arch", "qwen2-0.5b"])
    mesh = make_serving_mesh(2, device="cpu")
    cfg, split = serve.make_setup(args, mesh=mesh)[:2]
    want = sh.shard_params(serve.make_setup(args)[1], cfg, mesh)
    for got, ref in zip(split, want):
        a, b = dict(sh._leaves(got)), dict(sh._leaves(ref))
        assert a.keys() == b.keys()
        for path in a:
            assert torch.equal(a[path], b[path]), path


# ---------------------------------------------------------------------------
# against JAX's tp 1
# ---------------------------------------------------------------------------


def _jax_setup(arch, **over):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32", **over)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {
        "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(
            jnp.asarray(leaf, jnp.float32)
        )
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]
    }
    params = M.params_from_numpy(flat, cfg)
    jcorpus = jax_corpus(20, mean_doc_tokens=24, vocab=cfg.vocab_size, seed=0)
    corpus = make_corpus(20, mean_doc_tokens=24, vocab=cfg.vocab_size, seed=0)
    jidx = JaxIVF(jcorpus.doc_vectors, n_clusters=8, nprobe=4)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=8, nprobe=4)
    idx.centroids = np.array(jidx.centroids)
    idx.assign = np.array(jidx.assign)
    idx.lists = [np.array(x) for x in jidx.lists]
    kw = dict(
        n_requests=6,
        rate=100.0,
        question_tokens=8,
        vocab=cfg.vocab_size,
        zipf_s=1.2,
        seed=1,
    )
    jwl = jax_workload(jcorpus, **kw)
    wl = make_workload(corpus, **kw)
    return jcfg, jp, jcorpus, jidx, jwl, (cfg, params, corpus, idx, wl)


@pytest.mark.parametrize("arch,tps", [("qwen2-0.5b", (2,)), ("llama2-7b", (2, 4))])
def test_tp_matches_jax_tp1(arch, tps):
    jcfg, jp, jcorpus, jidx, jwl, setup = _jax_setup(arch)
    jrt = JaxRuntime(jcfg, jp, jcorpus, jidx, config=JaxEngineConfig(top_k=2))
    with contextlib.redirect_stdout(io.StringIO()):
        want = sorted(jrt.serve(jwl, max_new_tokens=3), key=lambda r: r.req_id)
    jstats = {k: jrt.tree.stats[k] for k in STATS}
    for tp in tps:
        rt, got = _serve(setup, tp)
        assert [r.req_id for r in got] == [r.req_id for r in want]
        assert {k: rt.tree.stats[k] for k in STATS} == jstats
        for a, b in zip(got, want):
            assert a.docs == b.docs
            assert a.tokens == b.tokens, (tp, a.req_id)
            linf = float(
                np.max(
                    np.abs(
                        a.first_logits.astype(np.float64)
                        - np.asarray(b.first_logits, np.float64)
                    )
                )
            )
            assert linf <= EPS, (tp, a.req_id, linf)
