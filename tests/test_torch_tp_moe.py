"""The MoE family under tensor-parallel serving, on the CPU with tp CPU
shards (``launch/mesh.py::make_serving_mesh(tp, device="cpu")``).

Reduced Mixtral-8x7B (4 experts, 4 / 2 heads) and Phi-3.5-MoE, with
``moe_dense`` and ``moe_capacity``, and the d_ff fallback (3 experts,
which do not split over tp 2).  Within the port: tp 2 gives the tokens,
tier hits, first-token logits and host copies of tp 1 over a one-device
mesh of column-slab group 2 bit for bit, in f32 and bf16.  Against JAX:
the port's tp 2 gives the tokens of JAX's tp 1, first-token logits within
1e-4.  Also ``serve.main --tp 2 --check-tokens``, the split draw, the
expert layout of ``sharding.placer`` and the first card's bytes.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import paged_prefill as PP
from repro_torch.launch import serve
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import model as M
from repro_torch.serving.runtime import ShardedPagedBackend

from test_torch_clock import constant_clock  # noqa: F401
from test_torch_tp import (EPS, STATS, TINY, _demote_all, _jax_setup, _same,
                           _serve)

MOE = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
VARIANTS = {
    "dense": {},
    "capacity": {"moe_impl": "capacity"},
    "ffn": {"moe_experts": 3},
}


def _cfg(arch, variant, dtype="float32"):
    return dataclasses.replace(get_reduced(arch), dtype=dtype,
                               **VARIANTS[variant])


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in MOE:
        for variant in VARIANTS:
            for dtype in ("float32", "bfloat16"):
                args = serve.build_parser().parse_args(
                    TINY + ["--arch", arch, "--requests", "6",
                            "--doc-tokens", "20"])
                cfg = _cfg(arch, variant, dtype)
                out[arch, variant, dtype] = serve.make_setup(args, cfg=cfg)[:5]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", MOE)
def test_moe_tp2_is_bit_identical_to_tp1(setups, arch, variant, dtype):
    setup = setups[arch, variant, dtype]
    _same(_serve(setup, 2), _serve(setup, 1, slabs=2))


@pytest.mark.parametrize("variant", ["dense", "ffn"])
def test_moe_host_copies_keep_the_bits(setups, variant):
    """Every cached node demoted through ShardedPagedBackend and the
    requests served again from the host tier: host copies, tokens, tier
    hits and logits equal tp 1's of group 2."""
    setup = setups["mixtral-8x7b", variant, "bfloat16"]
    runs = {}
    for tp in (1, 2):
        rt, first = _serve(setup, tp, slabs=2)
        assert isinstance(rt.tree.backend, ShardedPagedBackend) == (tp > 1)
        _demote_all(rt)
        host = {n.path(): (n.payload_host["k"], n.payload_host["v"])
                for n in rt.tree.nodes() if n.payload_host is not None}
        again = [dataclasses.replace(r, req_id=r.req_id + 100)
                 for r in setup[4]]
        second = sorted(rt.serve(again, max_new_tokens=3),
                        key=lambda r: r.req_id)
        runs[tp] = (rt, first + second, host)
    assert runs[1][0].tree.stats["hit_tokens_host"] > 0
    _same(runs[2][:2], runs[1][:2])
    assert runs[2][2].keys() == runs[1][2].keys() and runs[1][2]
    for path, want in runs[1][2].items():
        for got, ref in zip(runs[2][2][path], want):
            assert torch.equal(got, ref), path


def test_moe_paged_kernel_calls_scale_with_tp(setups):
    counts = {}
    for tp in (1, 2):
        PA.paged_decode_torch.calls = PP.paged_prefill_torch.calls = 0
        _serve(setups["mixtral-8x7b", "dense", "float32"], tp)
        counts[tp] = (PA.paged_decode_torch.calls,
                      PP.paged_prefill_torch.calls)
    assert min(counts[1]) > 0
    assert counts[2] == tuple(2 * n for n in counts[1])


@pytest.mark.parametrize("arch,variant", [("mixtral-8x7b", "dense"),
                                          ("mixtral-8x7b", "ffn"),
                                          ("phi3.5-moe-42b-a6.6b",
                                           "capacity")])
def test_moe_tp2_matches_jax_tp1(arch, variant):
    from repro.serving.config import EngineConfig as JaxEngineConfig
    from repro.serving.runtime import ContinuousRuntime as JaxRuntime

    jcfg, jp, jcorpus, jidx, jwl, setup = _jax_setup(arch, **VARIANTS[variant])
    jrt = JaxRuntime(jcfg, jp, jcorpus, jidx,
                     config=JaxEngineConfig(top_k=2))
    with contextlib.redirect_stdout(io.StringIO()):
        want = sorted(jrt.serve(jwl, max_new_tokens=3),
                      key=lambda r: r.req_id)
    rt, got = _serve(setup, 2)
    assert {k: rt.tree.stats[k] for k in STATS} == {
        k: jrt.tree.stats[k] for k in STATS}
    for a, b in zip(got, want):
        assert a.req_id == b.req_id and a.docs == b.docs
        assert a.tokens == b.tokens, a.req_id
        linf = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                   - np.asarray(b.first_logits, np.float64))))
        assert linf <= EPS, (a.req_id, linf)


@pytest.mark.parametrize("arch", MOE)
def test_serve_main_moe_tp2_check_tokens(capsys, arch):
    serve.main(TINY + ["--arch", arch, "--tp", "2", "--check-tokens"])
    out = capsys.readouterr().out
    assert "tensor parallel: tp=2 over a (1, 2) mesh" in out
    assert ("  expert rule  -> expert-parallel, 2 of 4 experts a shard; "
            "serving keeps the expert wd whole") in out
    assert "token check: all 4 requests identical" in out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_split_draw_equals_the_sharded_tree(variant):
    """make_setup over a mesh draws each MoE leaf and splits it at once:
    the shards equal shard_params of the whole draw, bit for bit."""
    args = serve.build_parser().parse_args(TINY + ["--arch", "mixtral-8x7b"])
    cfg = _cfg("mixtral-8x7b", variant, "bfloat16")
    mesh = make_serving_mesh(2, device="cpu")
    split = serve.make_setup(args, cfg=cfg, mesh=mesh)[1]
    want = sh.shard_params(serve.make_setup(args, cfg=cfg)[1], cfg, mesh)
    for got, ref in zip(split, want):
        a, b = dict(sh._leaves(got)), dict(sh._leaves(ref))
        assert a.keys() == b.keys()
        for path in a:
            assert torch.equal(a[path], b[path]), path


def test_expert_layout_of_the_placer():
    """E split: whole experts a shard (no slabs); d_ff split: each shard's
    columns as slabs ahead of the experts, (L, slabs, E, D, F / G); the
    router's columns slab-major when E splits over the group, else whole
    on the controller; the expert wd whole on the controller."""
    cfg = dataclasses.replace(_cfg("mixtral-8x7b", "dense"), n_kv_heads=4)
    params = M.init_params(cfg, 0)
    blk = params["blocks"]
    one = sh.shard_params(params, cfg, make_serving_mesh(2, device="cpu"))
    for i, shard in enumerate(one):
        assert torch.equal(shard["blocks"]["wg"], blk["wg"].chunk(2, 1)[i])
        assert torch.equal(shard["blocks"]["router"],
                           blk["router"].chunk(2, -1)[i])
        assert shard["blocks"]["wd"] is blk["wd"]
    (g4,) = sh.shard_params(params, cfg,
                            make_serving_mesh(1, device="cpu", slabs=4))
    assert torch.equal(g4["blocks"]["wg"], blk["wg"])       # whole experts
    assert torch.equal(g4["blocks"]["router"][:, 3], blk["router"][..., 3:])
    ffn = dataclasses.replace(cfg, moe_experts=3)
    params = M.init_params(ffn, 0)
    wg = params["blocks"]["wg"]                             # (L, 3, D, F)
    shards = sh.shard_params(params, ffn,
                             make_serving_mesh(2, device="cpu", slabs=4))
    for i, shard in enumerate(shards):
        got = shard["blocks"]["wg"]                         # (L, 2, 3, D, F/4)
        assert got.shape == wg.shape[:1] + (2,) + wg.shape[1:3] + (
            wg.shape[3] // 4,)
        for j in range(2):
            assert torch.equal(got[:, j], wg.chunk(4, -1)[2 * i + j])
        assert shard["blocks"]["router"] is params["blocks"]["router"]
    assert sh.expert_rule(ffn, 2) == "ffn" and not sh.router_split(ffn, 2)


def test_moe_card_bytes_and_the_full_size_check(monkeypatch):
    """Mixtral-8x7B on the first card: 62.74 GB at tp 2 and 47.18 GB at tp
    4 at the split draw's peak (the expert wd, 30.06 GB, whole), so
    --full-size --tp 2 passes the check; at tp 1 the 93.4 GB of weights
    do not fit."""
    cfg = get_config("mixtral-8x7b")
    wd = 2 * cfg.n_layers * cfg.moe_experts * cfg.d_ff * cfg.d_model
    assert round(wd / 1e9, 2) == 30.06
    assert round(sh.card_bytes(cfg, 2) / 1e9, 2) == 62.74
    assert round(sh.card_bytes(cfg, 4) / 1e9, 2) == 47.18

    class Drawn(Exception):
        pass

    init = M.init_params

    def no_draw(cfg, seed, device="cpu", **kw):
        if str(device) != "meta":
            raise Drawn
        return init(cfg, seed, device, **kw)

    monkeypatch.setattr(M, "init_params", no_draw)
    base = ["--device", "cpu", "--full-size", "--arch", "mixtral-8x7b"]
    with pytest.raises(Drawn):
        serve.make_setup(serve.build_parser().parse_args(base + ["--tp", "2"]))
    with pytest.raises(ValueError, match=r"93\.4 GB.*tensor parallelism"):
        serve.make_setup(serve.build_parser().parse_args(base))
