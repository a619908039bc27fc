"""The port's serving mesh and partition rules (``launch/mesh.py``,
``launch/sharding.py``) against the JAX package's, and the pieces of the
tensor-parallel path one at a time, on the CPU: the column-slab group
of a mesh (``layers.col_proj`` over ``sharding.placer``'s slab-major
leaves), ``layers.dense_rowsum``, the per-shard attention
dispatch of ``kernels/ops.py``, the sharded pool's ``_shard_segment`` and
``ShardedPagedBackend``'s round trips, and the per-card ``--full-size``
check.

The specs are compared as tuples: the reference's ``param_spec`` takes any
leaf with ``ndim``/``shape`` and a mesh with ``shape``/``axis_names``, so
it runs here without devices, on the shapes of its own tree
(``jax.eval_shape`` of its init).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import repro.launch.sharding as jsh
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config, get_reduced, list_configs
from repro_torch.kernels import ops
from repro_torch.kvcache.paged import PagedKVStore
from repro_torch.launch import serve
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.runtime import PagedBackend, ShardedPagedBackend

ARCHS = list_configs()


def _keys(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jax_shapes(arch):
    return jax.eval_shape(
        lambda: JM.init_params(jax_config(arch), jax.random.PRNGKey(0))
    )


def _jax_leaves(shapes):
    return {
        _keys(path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }


@pytest.fixture(scope="module")
def trees():
    return {
        arch: (_jax_shapes(arch), M.init_params(get_config(arch), 0, "meta"))
        for arch in ARCHS
    }


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(trees, arch, tp):
    jshapes, tree = trees[arch]
    jleaves = _jax_leaves(jshapes)
    mesh = make_serving_mesh(tp, device="cpu")
    ours = dict(sh._leaves(tree))
    assert ours.keys() == jleaves.keys()
    for path, leaf in ours.items():
        want = tuple(jsh.param_spec(path, jleaves[path], jax_config(arch), mesh))
        assert sh.param_spec(path, leaf, get_config(arch), mesh) == want, path


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_param_shardings_match_reference(trees, arch, monkeypatch):
    jshapes, tree = trees[arch]
    mesh = make_serving_mesh(4, device="cpu")
    captured = {}

    def capture(tree, spec_fn, mesh):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            captured[_keys(path)] = tuple(spec_fn(_keys(path), leaf))

    monkeypatch.setattr(jsh, "tree_shardings", capture)
    jsh.serving_param_shardings(jax_config(arch), jshapes, mesh)
    ours = dict(sh._leaves(sh.serving_param_shardings(get_config(arch), tree, mesh)))
    assert ours == captured
    assert all(s == () for p, s in ours.items() if p[-1] in ("wo", "wd"))


def test_rules_and_summary():
    cfg = get_config("qwen2-0.5b")
    mesh = make_serving_mesh(2, device="cpu")
    assert sh.pool_kv_spec() == (None, None, None, "model", None)
    assert sh._clean_tps(cfg) == jsh._clean_tps(jax_config("qwen2-0.5b")) == [1, 2]
    tree = M.init_params(cfg, 0, "meta")
    text = sh.spec_summary(cfg, mesh, tree)
    assert text.splitlines()[0] == (
        "partition specs over model=2 (fused heads tile cleanly: True; "
        "whole-KV-head serving split: True):"
    )
    assert "  wq           -> (None, None, 'model')" in text
    assert "  ln1          -> replicated" in text
    assert "  embed        -> ('model', None)" in text


def test_make_serving_mesh(monkeypatch):
    mesh = make_serving_mesh(4, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.shape == {"data": 1, "model": 4}
    assert mesh.axis_names == ("data", "model")
    one = make_serving_mesh(2, devices=["cuda:0", "cuda:0"])
    assert one.devices == (torch.device("cuda", 0),) * 2
    assert one.controller == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        make_serving_mesh(0)
    with pytest.raises(ValueError, match="needs 3 devices, got 2"):
        make_serving_mesh(3, devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices but only 1 are visible"):
        make_serving_mesh(2)
    assert make_serving_mesh(1).devices == (torch.device("cuda", 0),)
    # the column-slab group: tp unless given, a multiple of tp
    assert mesh.slabs == 4 and make_serving_mesh(1, device="cpu").slabs == 1
    assert make_serving_mesh(2, device="cpu", slabs=8).slabs == 8
    with pytest.raises(ValueError, match="group of 6 does not split over tp 4"):
        make_serving_mesh(4, device="cpu", slabs=6)


def _leaves_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _storages(tree):
    return {t.untyped_storage().data_ptr() for _, t in sh._leaves(tree)}


def test_shard_params_copies_and_shared_leaves():
    """A split leaf's parts are copies that share no storage with the
    tree (so the runtime keeps no whole leaf alive); a whole leaf is the
    tree's own tensor, shared by every shard."""
    cfg = get_reduced("llama2-7b")
    params = M.init_params(cfg, 0)
    shards = sh.shard_params(params, cfg, make_serving_mesh(4, device="cpu"))
    assert len(shards) == 4
    for i, shard in enumerate(shards):
        assert shard["blocks"]["wo"] is params["blocks"]["wo"]
        assert shard["final_norm"] is params["final_norm"]
        for name in ("wq", "wk", "wv", "wg", "wu"):
            part = shard["blocks"][name]
            assert part.is_contiguous()
            assert torch.equal(part, params["blocks"][name].chunk(4, -1)[i])
        assert torch.equal(shard["embed"], params["embed"].chunk(4, 0)[i])
        assert torch.equal(shard["lm_head"], params["lm_head"].chunk(4, -1)[i])
        split = {
            t.untyped_storage().data_ptr()
            for path, t in sh._leaves(shard)
            if t is not _leaves_get(params, path)
        }
        assert split and not split & _storages(params)
    assert sh.shard_params(params, cfg, make_serving_mesh(1, device="cpu")) == [params]


def test_slab_group_must_split_over_tp_and_whole_heads():
    """A mesh's column-slab group is a multiple of tp, and tiles whole
    heads; every tp dividing both head counts serves (tp 8 on
    LLaMA2-70B's 64 / 8 heads, the reference's hint)."""
    assert sh._clean_tps(get_config("llama2-70b")) == [1, 2, 4, 8]
    cfg = dataclasses.replace(
        get_reduced("llama2-7b"), n_heads=8, n_kv_heads=8, d_model=512
    )
    params = M.init_params(cfg, 0)
    assert len(sh.shard_params(params, cfg, make_serving_mesh(8, device="cpu"))) == 8
    with pytest.raises(ValueError, match="would split a head"):
        sh.shard_params(params, cfg, make_serving_mesh(1, device="cpu", slabs=16))
    moe = get_reduced("mixtral-8x7b")
    assert len(sh.shard_params(M.init_params(moe, 0), moe,
                               make_serving_mesh(2, device="cpu"))) == 2
    with pytest.raises(NotImplementedError, match="under a mesh is not ported"):
        sh.placer(get_reduced("hymba-1.5b"), make_serving_mesh(2, device="cpu"))


def test_card_bytes_and_the_full_size_check(monkeypatch):
    """LLaMA2-70B on the first card of four: 70.7 GB held (the split
    leaves / 4, wo and wd whole), 72.6 GB at the split draw's peak (wd
    drawn whole in flight, with one layer's f32 draw), so --full-size --tp
    4 passes the check; at tp 2 it does not, and the message gives the
    first card's figure."""
    cfg = get_config("llama2-70b")
    D, F, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    rows = 2 * nl * (cfg.n_heads * cfg.hd * D + F * D)  # wo + wd, bf16
    held = rows + (cfg.n_params() * 2 - rows) / 4
    assert abs(held / 1e9 - 70.7) < 0.05
    assert sh.card_bytes(cfg, 4) == pytest.approx(held + 8 * F * D, rel=1e-4)
    assert abs(sh.card_bytes(cfg, 4) / 1e9 - 72.6) < 0.05
    assert sh.card_bytes(cfg, 1) == pytest.approx(cfg.n_params() * 2, rel=1e-4)

    class Drawn(Exception):
        pass

    init = M.init_params

    def no_draw(cfg, seed, device="cpu", **kw):
        if str(device) != "meta":
            raise Drawn
        return init(cfg, seed, device, **kw)

    monkeypatch.setattr(M, "init_params", no_draw)
    base = ["--device", "cpu", "--full-size", "--arch", "llama2-70b"]
    with pytest.raises(Drawn):
        serve.make_setup(serve.build_parser().parse_args(base + ["--tp", "4"]))
    with pytest.raises(ValueError, match=r"--tp 2: 95\.0 GB .* first card"):
        serve.make_setup(serve.build_parser().parse_args(base + ["--tp", "2"]))
    with pytest.raises(ValueError, match=r"138\.0 GB.*tensor parallelism"):
        serve.make_setup(serve.build_parser().parse_args(base))


# ---------------------------------------------------------------------------
# column slabs and the row-parallel sites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,slabs", [(896, 896, 2), (896, 4864, 2), (256, 512, 4)])
def test_col_proj_shards_keep_tp1_bits(dtype, K, N, slabs):
    """A shard's columns in its slabs equal a one-device mesh's of the same
    group, for every tp dividing it, at every row count; the bias goes
    with its columns, and a slab is one contiguous (K, N / slabs) call."""
    cfg = dataclasses.replace(get_reduced("llama2-7b"), n_heads=4, n_kv_heads=4)
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(1, K, N, generator=g) * 0.02).to(dtype)
    b = torch.randn(1, N, generator=g).to(dtype)

    def place(tp):
        put = sh.placer(cfg, make_serving_mesh(tp, device="cpu", slabs=slabs))
        return zip(put(("blocks", "wq"), w), put(("blocks", "bq"), b))

    for m in (1, 3, 8, 64):
        x = torch.randn(m, K, generator=g).to(dtype)
        ((w1, b1),) = place(1)
        whole = L.col_proj(x, w1[0], b1[0], slabs)
        parts = zip(w[0].chunk(slabs, 1), b[0].chunk(slabs))
        slabbed = torch.cat(
            [L.proj(x, wi.contiguous(), bi) for wi, bi in parts], dim=-1
        )
        assert torch.equal(whole, slabbed)
        for tp in (t for t in (2, 4) if slabs % t == 0):
            got = [L.col_proj(x, wi[0], bi[0], slabs // tp) for wi, bi in place(tp)]
            assert torch.equal(torch.cat(got, dim=-1), whole)


def test_dense_rowsum_gathers_then_contracts_whole():
    g = torch.Generator().manual_seed(1)
    w = torch.randn(64, 32, generator=g)
    x = torch.randn(5, 64, generator=g)
    assert torch.equal(L.dense_rowsum(list(x.chunk(4, -1)), w), L.proj(x, w))
    assert torch.equal(L.dense_rowsum(x, w), L.proj(x, w))


# ---------------------------------------------------------------------------
# per-shard attention dispatch
# ---------------------------------------------------------------------------


def _runs(rng, B, n_slots, page, n_pages):
    tables = rng.integers(1, n_pages, (B, n_slots)).astype(np.int32)
    counts = rng.integers(0, page + 1, (B, n_slots)).astype(np.int32)
    counts[:, 0] = page
    starts = (np.arange(n_slots, dtype=np.int32) * page)[None].repeat(B, 0)
    return [torch.from_numpy(a) for a in (tables, counts, starts)]


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_ops_equal_the_whole_heads(tp):
    rng = np.random.default_rng(0)
    B, H, KV, hd, page, n_pages, n_slots, L_ = 3, 8, 4, 64, 8, 20, 4, 2
    kp = torch.from_numpy(rng.standard_normal((L_, n_pages, page, KV, hd)))
    vp = torch.from_numpy(rng.standard_normal((L_, n_pages, page, KV, hd)))
    kp, vp = kp.float(), vp.float()
    tables, counts, starts = _runs(rng, B, n_slots, page, n_pages)
    mesh = make_serving_mesh(tp, device="cpu")
    kps = [t.contiguous() for t in kp.chunk(tp, 3)]
    vps = [t.contiguous() for t in vp.chunk(tp, 3)]
    q = torch.from_numpy(rng.standard_normal((B, H, hd))).float()
    qpos = (counts.sum(1) - 1).to(torch.int32)
    args = (tables, counts, starts, qpos, 1, 0)
    whole = ops.paged_decode_attention(q, kp, vp, *args)
    split = ops.paged_decode_attention(q, kps, vps, *args, mesh=mesh)
    assert torch.equal(split, whole)
    Sq = 5
    qp = torch.from_numpy(rng.standard_normal((B, H, Sq, hd))).float()
    q_start = torch.tensor([page, 0, 2 * page], dtype=torch.int32)
    q_len = torch.tensor([5, 3, 0], dtype=torch.int32)
    args = (tables, counts, starts, q_start, q_len, 0, 0)
    whole = ops.paged_prefill_attention(qp, kp, vp, *args)
    split = ops.paged_prefill_attention(qp, kps, vps, *args, mesh=mesh)
    assert torch.equal(split, whole)
    with pytest.raises(ValueError, match="pool planes"):
        ops.paged_decode_attention(q, kps[:1], vps[:1], *args[:4], 1, 0, mesh=mesh)


# ---------------------------------------------------------------------------
# the sharded pool and its backend
# ---------------------------------------------------------------------------


def _store(tp, KV=4, n_blocks=16):
    mesh = None if tp == 1 else make_serving_mesh(tp, device="cpu")
    return PagedKVStore(2, n_blocks, 4, KV, 8, dtype=torch.bfloat16, mesh=mesh)


def _segment(seed, T=11, KV=4):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(2, 1, T, KV, 8, generator=g).to(torch.bfloat16) for _ in "kv"]


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_segment_put_gather_round_trip(tp):
    store, one = _store(tp), _store(1)
    k, v = _segment(0)
    ks, vs = store._shard_segment(k, v)
    assert len(ks) == len(vs) == tp
    for i, (kk, vv) in enumerate(zip(ks, vs)):
        assert torch.equal(kk, k.chunk(tp, 3)[i]) and torch.equal(vv, v.chunk(tp, 3)[i])
    seg, seg1 = store.put(k, v, reserve_tokens=3), one.put(k, v, reserve_tokens=3)
    assert seg.blocks == seg1.blocks
    for got, want in zip(store.gather(seg), (k, v)):
        assert torch.equal(got, want)
    k2, v2 = _segment(1, T=6)
    store.append(seg, k2, v2)
    one.append(seg1, k2, v2)
    for got, want in zip(store.gather(seg), one.gather(seg1)):
        assert torch.equal(got, want)
    for i, plane in enumerate(store.k_planes):
        assert torch.equal(plane, one.k_planes[0].chunk(tp, 3)[i])
    assert store.bytes_per_token() == one.bytes_per_token()


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_backend_round_trip(tp):
    """swap_out reassembles the whole heads' host copy (tp 1's, bit for
    bit); load puts it back through _shard_segment."""
    store, one = _store(tp), _store(1)
    back, back1 = ShardedPagedBackend(store), PagedBackend(one)
    k, v = _segment(2)

    class Node:
        payload_gpu = payload_host = None

    node, node1 = Node(), Node()
    node.payload_gpu, node1.payload_gpu = store.put(k, v), one.put(k, v)
    back.swap_out(node)
    back1.swap_out(node1)
    for name in "kv":
        assert torch.equal(node.payload_host[name], node1.payload_host[name])
    back.free_gpu(node)
    back.load(node)
    for got, want in zip(store.gather(node.payload_gpu), (k, v)):
        assert torch.equal(got, want)
    store.pool.check()


# the column slabs' shapes (K, N / 4) a card probe found row-variant
# without slabs of rows (layers.py's docstring), and some it found
# row-invariant; the rule must slab the first and may leave the second
SLAB_VARIANT = [
    (4096, 1024),
    (4096, 256),
    (4096, 2752),
    (4608, 1024),
    (4608, 512),
    (7168, 1792),
    (7168, 256),
    (7168, 7168),
    (8192, 2048),
    (8192, 7168),
]
SLAB_INVARIANT = [(4096, 3584), (3840, 3840), (896, 448), (896, 2432)]


def test_row_rule_at_the_column_slab_shapes():
    for shape in SLAB_VARIANT:
        assert L.slabbed(torch.empty(shape, device="meta")), shape
    for shape in SLAB_INVARIANT:
        assert not L.slabbed(torch.empty(shape, device="meta")), shape
    # the slab shapes of a group of 4: LLaMA2-7B's gate/up
    cfg = get_config("llama2-7b")
    assert cfg.d_ff // 4 == 2752


# ---------------------------------------------------------------------------
# the training half of the rules, against the reference's
# ---------------------------------------------------------------------------


class FakeMesh:
    """A stand-in (data, model) mesh: the rules read only ``shape`` and
    ``axis_names`` (as tests/test_sharding.py's does)."""

    axis_names = ("data", "model")

    def __init__(self, n_data, n_model):
        self.shape = {"data": n_data, "model": n_model}


MESHES = [(2, 4), (1, 8), (16, 16)]


def _capture(monkeypatch):
    """Make the reference's tree_shardings return its specs as a dict by
    path (the keys it would name them by)."""
    captured = {}

    def capture(tree, spec_fn, mesh):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            captured[_keys(path)] = tuple(spec_fn(_keys(path), leaf))
        return captured

    monkeypatch.setattr(jsh, "tree_shardings", capture)
    return captured


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(trees, arch, shape,
                                             monkeypatch):
    jshapes, tree = trees[arch]
    mesh = FakeMesh(*shape)
    captured = _capture(monkeypatch)
    jsh.param_shardings(jax_config(arch), jshapes, mesh)
    ours = dict(sh._leaves(sh.param_shardings(get_config(arch), tree, mesh)))
    assert ours == captured
    jleaves = _jax_leaves(jshapes)
    for path, leaf in sh._leaves(tree):
        ps = sh.param_spec(path, leaf, get_config(arch), mesh)
        want = tuple(jsh.opt_spec(jsh.P(*ps), jleaves[path], mesh))
        assert sh.opt_spec(ps, leaf, mesh) == want, path
    from repro_torch.training.optimizer import AdamWState
    state = AdamWState(step=None, m=tree, v=tree)
    osh = sh.opt_shardings(get_config(arch), tree, state, mesh)
    assert osh.step == ()
    for path, leaf in sh._leaves(tree):
        ps = sh.param_spec(path, leaf, get_config(arch), mesh)
        assert dict(sh._leaves(osh.m))[path] == sh.opt_spec(ps, leaf, mesh)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_input_specs_match_reference(arch, shape, monkeypatch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = FakeMesh(*shape)
    for batch in (1, 3, 8, 16, 256):
        assert sh.batch_spec(cfg, batch, mesh) == jsh.batch_spec(jcfg, batch,
                                                                 mesh)
    shapes = {"tokens": (16, 64), "labels": (16, 64), "pos": (16,),
              "step": (), "patch_embeds": (16, 4, 32), "odd": (3, 5)}
    captured = _capture(monkeypatch)
    jsh.input_shardings(jcfg, {k: jax.ShapeDtypeStruct(v, np.float32)
                               for k, v in shapes.items()}, mesh)
    ours = sh.input_shardings(cfg, {k: torch.empty(v, device="meta")
                                    for k, v in shapes.items()}, mesh)
    assert {(k,): v for k, v in ours.items()} == captured


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, shape, monkeypatch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = FakeMesh(*shape)
    for batch in (1, 16, 128):
        jcache = jax.eval_shape(lambda: JM.init_decode_cache(jcfg, batch, 64))
        captured = _capture(monkeypatch)
        jsh.cache_shardings(jcfg, jcache, mesh, batch)
        cache = M.init_decode_cache(cfg, batch, 64, device="meta")
        ours = sh.cache_shardings(cfg, cache, mesh, batch)
        flat = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, path + (str(i),))
            elif node is not None:
                flat[path] = node

        walk(_as_lists(ours), ())
        assert flat == captured and captured, (batch, flat, captured)


def _as_lists(tree):
    """A spec tree's containers of specs as lists (a spec is itself a
    tuple), so that walking it tells the two apart."""
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and all(
            isinstance(t, tuple) for t in tree):
        return [_as_lists(t) for t in tree]
    return tree


def test_debug_mesh_and_data_axes(monkeypatch):
    from repro_torch.launch.mesh import DeviceMesh, data_axes, make_debug_mesh
    mesh = make_debug_mesh(device="cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model") and data_axes(mesh) == ("data",)
    assert mesh.replica(0).slabs == 4 and len(mesh.devices) == 8
    assert mesh.replica(1).devices == (torch.device("cpu"),) * 4
    one = make_debug_mesh(2, 2, devices=["cuda:0"] * 4)
    assert one.replica(1).controller == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        make_debug_mesh(2, 2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 8 devices but only 1"):
        make_debug_mesh()
    with pytest.raises(ValueError, match="one length"):
        DeviceMesh(((torch.device("cpu"),), ()))
    serving = make_serving_mesh(2, device="cpu")
    assert serving.replica(0) is serving
    assert data_axes(serving) == ("data",)
    assert jsh.data_axes(FakeMesh(2, 4)) == data_axes(FakeMesh(2, 4))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x7b", "internvl2-1b"])
def test_place_train_splits_by_param_spec_and_gathers_back(arch):
    """The training layout: a leaf param_spec splits over model is a tuple
    of its chunks along that dim (wo/wd rows too), a replicated leaf one
    tensor; every replica holds its own copies; gather_train gives the
    tree back bit for bit."""
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = M.init_params(cfg, 0)
    mesh = make_debug_mesh(2, 2, device="cpu")
    placed = sh.place_train(params, cfg, mesh)
    assert len(placed) == 2
    dims = sh.train_dims(cfg, mesh)
    for path, leaf in sh._leaves(params):
        spec = sh.param_spec(path, leaf, cfg, mesh)
        got = [dict(sh._leaves(p))[path] for p in placed]
        if "model" in spec:
            d = spec.index("model")
            assert dims[path][0] == d
            for rep in got:
                assert isinstance(rep, tuple) and len(rep) == 2
                assert all(torch.equal(a, b)
                           for a, b in zip(rep, leaf.chunk(2, d)))
            assert got[0][0].data_ptr() != got[1][0].data_ptr()
        else:
            assert torch.equal(got[0], leaf) and got[0] is not leaf
    assert isinstance(dict(sh._leaves(placed[0]))[("blocks", "wo")], tuple)
    back = sh.gather_train(placed, cfg, mesh)
    for path, leaf in sh._leaves(params):
        assert torch.equal(dict(sh._leaves(back))[path], leaf), path
    # every family takes the training layout; Hymba's SSM columns and rows
    # split as param_spec says and gather back bit for bit
    hy = get_reduced("hymba-1.5b")
    hp = M.init_params(hy, 0)
    hplaced = sh.place_train(hp, hy, mesh)
    for name in ("ssm_in", "ssm_out"):
        got = dict(sh._leaves(hplaced[1]))[("blocks", name)]
        assert isinstance(got, tuple) and len(got) == 2, name
    for path, leaf in sh._leaves(hp):
        assert torch.equal(dict(sh._leaves(sh.gather_train(
            hplaced, hy, mesh)))[path], leaf), path
