"""The compile analysis's layout options against the JAX package's
module globals: ``seq-par`` (``layers.flash_attention_seqpar``, the
reference's under ``SEQ_PARALLEL_AXIS``), ``flat-gqa`` (``FLAT_GQA``) and
``attn-fallback`` (``ATTN_REPLICATE_IF_RAGGED``).

The plain versions in f32 within 1e-5 of the reference's (its seq-par
with-sharding constraint under a one-device mesh); the seq-par prefill
over a (1, 4) mesh of CPU shards bit for bit the unsplit prefill's
(chunks start at multiples of the 128-row block); ``param_spec`` under
the ragged-heads rule equal to the reference's on a stand-in mesh; a
train step under each option on a (2, 2) mesh within
``tests/test_torch_tp_train.py``'s tolerances of JAX's loss and grads;
and the dry run of each option at reduced size.
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
from repro.launch import sharding as jsh
from repro.models import layers as JL
from repro.models import model as JM
from repro.training.train_lib import loss_fn as jax_loss_fn
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import ServingMesh, make_debug_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training import optimizer as O
from repro_torch.training import train_lib as TL

TOL = 1e-5
LOSS_RTOL = 1e-5
SEQ_CHUNK = 16


def _qkv(seed, B, Sq, P, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, P + Sq, KV, hd)).astype(np.float32),
            rng.standard_normal((B, P + Sq, KV, hd)).astype(np.float32))


CASES = [
    dict(B=1, Sq=1100, P=0, H=4, KV=2, hd=64, window=0, cap=0.0),
    dict(B=2, Sq=700, P=300, H=4, KV=1, hd=64, window=256, cap=0.0),
    dict(B=1, Sq=1024, P=0, H=2, KV=2, hd=128, window=0, cap=30.0),
]


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_seqpar_attention_matches_the_reference(case):
    q, k, v = _qkv(1, case["B"], case["Sq"], case["P"], case["H"],
                   case["KV"], case["hd"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with mesh:
        want = jax.jit(lambda q, k, v: JL.flash_attention_seqpar(
            q, k, v, q_offset=case["P"], window=case["window"],
            logit_cap=case["cap"]))(q, k, v)
    got = L.flash_attention_seqpar(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        q_offset=case["P"], window=case["window"], logit_cap=case["cap"],
        devices=["cpu"] * 4)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL


FLAT = [dict(c, P=0) for c in CASES]


@pytest.mark.parametrize("case", FLAT, ids=range(len(FLAT)))
def test_flat_gqa_attention_matches_the_reference(case):
    q, k, v = _qkv(2, case["B"], case["Sq"], case["P"], case["H"],
                   case["KV"], case["hd"])
    prev = JL.FLAT_GQA
    JL.FLAT_GQA = True
    try:
        want = jax.jit(lambda q, k, v: JL.flash_attention(
            q, k, v, q_offset=case["P"], window=case["window"],
            logit_cap=case["cap"]))(q, k, v)
    finally:
        JL.FLAT_GQA = prev
    rep = M._Replica({}, ServingMesh((torch.device("cpu"),)),
                     sh.Options(flat_gqa=True))
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"),
                              attn_logit_softcap=case["cap"])
    got = M._attend(cfg, rep, torch.as_tensor(q), torch.as_tensor(k),
                    torch.as_tensor(v), case["window"], None)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL


def test_seqpar_prefill_is_bit_identical_to_the_unsplit_prefill():
    """Yi's reduced heads (7 / 1) do not split over 4: the seq-par prefill
    deals 512-row chunks over the 4 shards; logits and cache are the
    unsplit prefill's bits."""
    cfg = dataclasses.replace(get_reduced("yi-34b"), dtype="float32")
    params = M.init_params(cfg, 0)
    mesh = make_debug_mesh(1, 4, device="cpu")
    placed = sh.place_train(params, cfg, mesh)[0]
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 1536), dtype=np.int32))
    with torch.no_grad():
        a, ca = M.replica_prefill(cfg, placed, {"tokens": toks},
                                  mesh=mesh.replica(0))
        b, cb = M.replica_prefill(cfg, placed, {"tokens": toks},
                                  mesh=mesh.replica(0),
                                  opts=sh.Options(seq_par=True))
    assert torch.equal(a, b)
    assert torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"])


class FakeMesh:
    def __init__(self, d, m):
        self.shape = {"data": d, "model": m}
        self.axis_names = ("data", "model")


class Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


@pytest.mark.parametrize("arch", ["yi-34b", "qwen2-0.5b", "hymba-1.5b",
                                  "mixtral-8x7b", "xlstm-1.3b"])
def test_fallback_param_spec_matches_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    tree = M.init_params(cfg, 0, device="meta")
    prev = jsh.ATTN_REPLICATE_IF_RAGGED
    jsh.ATTN_REPLICATE_IF_RAGGED = True
    try:
        for shape in ((16, 16), (2, 4), (1, 8)):
            mesh = FakeMesh(*shape)
            for path, leaf in sh._leaves(tree):
                want = tuple(jsh.param_spec(path, Leaf(leaf.shape), jcfg,
                                            mesh))
                got = sh.param_spec(path, leaf, cfg, mesh, fallback=True)
                pad = got + (None,) * (leaf.ndim - len(got))
                assert pad == want + (None,) * (leaf.ndim - len(want)), \
                    (shape, path, got, want)
    finally:
        jsh.ATTN_REPLICATE_IF_RAGGED = prev


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("opt", ["attn-fallback", "flat-gqa", "seq-par"])
def test_a_train_step_under_each_option_matches_jax(opt):
    """Yi reduced (7 / 1 heads, ragged over 2): on a (2, 2) mesh the loss
    and every grad leaf within JAX's tolerances (the options change the
    layout, not the function; seq-par touches the prefill only), and the
    ZeRO-1 step keeps the replicas' params identical."""
    jcfg = dataclasses.replace(jax_reduced("yi-34b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("yi-34b"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    params = M.params_from_numpy(_flat(jp), cfg)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, 32),
                                    dtype=np.int32)}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
        seq_chunk=SEQ_CHUNK)))(jp)
    lay = dryrun.options([opt])
    mesh = make_debug_mesh(2, 2, device="cpu")
    placed = sh.place_train(params, cfg, mesh, lay)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads = TL.sharded_loss_and_grads(cfg, placed, tb, mesh,
                                            seq_chunk=SEQ_CHUNK, opts=lay)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    dims = sh.train_dims(cfg, mesh, lay)
    tg = {}
    for d, g in enumerate(grads):
        for path, part in sh._leaves(g):
            if dims[path].data_split:
                whole = torch.cat([p.detach() for p in part], dims[path].data)
            elif isinstance(part, tuple):
                whole = torch.cat(part, dims[path].model)
            else:
                whole = part
            key = "/".join(path)
            tg[key] = tg.get(key, 0) + whole.numpy()
    for key, g_ref in _flat(jg).items():
        err = float(np.max(np.abs(tg[key] - g_ref)))
        assert err <= 1e-4 * float(np.max(np.abs(g_ref))) + 1e-6, (key, err)
    if opt == "attn-fallback":
        assert dims[("blocks", "wq")].data_split
        assert placed[0]["blocks"]["wq"].shape[-1] == \
            params["blocks"]["wq"].shape[-1] // 2
    state = O.init_state_zero(dims, placed, mesh)
    new, state, _ = TL.make_train_step(cfg, O.AdamWConfig(), mesh=mesh,
                                       opts=lay)(placed, state, tb)
    back = sh.gather_train(new, cfg, mesh, opts=lay)
    assert all(bool(torch.isfinite(t).all()) for _, t in sh._leaves(back))
    for (path, a), (_, b) in zip(sh._leaves(new[0]), sh._leaves(new[1])):
        if not dims[path].data_split:
            pa = a if isinstance(a, tuple) else (a,)
            pb = b if isinstance(b, tuple) else (b,)
            assert all(torch.equal(x, y) for x, y in zip(pa, pb)), path


@pytest.mark.parametrize("arch", ["yi-34b", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_every_option_dry_runs(arch, tmp_path, monkeypatch):
    """``launch/dryrun.py``'s ``run_one`` with each --opt at train_4k and
    prefill_32k, at the reduced config and on a (4, 4) mesh of fake cards
    in place of the production mesh: every record ok, the layout notes
    naming the option."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    small = dryrun.fake_mesh
    monkeypatch.setattr(dryrun, "fake_mesh",
                        lambda n_data, n_model, pods=1: small(4, 4))
    monkeypatch.setattr(specs, "SHAPES", dict(
        specs.SHAPES, train_4k=dict(kind="train", seq=64, batch=8),
        prefill_32k=dict(kind="prefill", seq=1024, batch=8)))
    for opt in dryrun.OPTS:
        for shape in ("train_4k", "prefill_32k"):
            rec = dryrun.run_one(arch, shape, False, tmp_path, opts=(opt,))
            assert rec["status"] == "ok", (opt, shape, rec.get("error"))
            assert rec["roofline"]["t_compute_s"] > 0
            if opt in ("seq-par", "attn-fallback"):
                assert any(opt in n for n in rec["partition_specs"]), opt
