"""The recurrent decode state in the reference's layout on a ``(data,
model)`` mesh (``launch/sharding.py::state_layout``), against JAX.

Hymba's ``ssm`` (L, B, H, hd, N) lies hd over model; every xLSTM state
leaf its largest dim of at least 4 x model over model (mLSTM's C by its
rows, n, the conv buffer and the sLSTM state by hd; mLSTM's per-head m
whole on the controller); the batch over the data axes when they divide
it, replica 0 holding its rows.  ``model.replica_prefill`` (its final
state written into that layout) and three ``replica_decode_step`` calls,
each shard stepping its part, against ``repro.models.model.prefill`` and
``decode_step``: the logits of each within ``LOGIT_RTOL`` x max |logit|
in f32 at reduced size (xLSTM with an sLSTM block every 2, so both block
kinds run).  Before and after every step each state leaf's parts lie on
the devices and in the shard shapes that ``cache_shardings`` gives: on
CPU shards here, and on a mesh of fake cards (each card its own device)
through the compile analysis's decode step.  Also: the state on the
busiest card of the (16, 16) production mesh.
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
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M

LOGIT_RTOL = 1e-5
STEPS = 3
S = 21
MAX_LEN = 24
ARCHS = ["xlstm-1.3b", "hymba-1.5b"]
# (mesh, batch): the data axes divide the batch on (2, 2) only
MESHES = [((1, 4), 1), ((2, 4), 1), ((2, 2), 2)]


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


_SETUP = {}


def _setup(arch):
    if arch not in _SETUP:
        jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        assert cfg.family != "ssm" or cfg.slstm_every == 2
        jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
        _SETUP[arch] = (jcfg, jp, cfg, M.params_from_numpy(_flat(jp), cfg))
    return _SETUP[arch]


_REF = {}


def _reference(arch, batch):
    """The reference's prefill of S tokens, then STEPS decode steps (Hymba
    over its K/V copied into a cache of MAX_LEN positions): the tokens and
    the logits of each."""
    if (arch, batch) not in _REF:
        jcfg, jp, cfg, _ = _setup(arch)
        rng = np.random.default_rng(batch)
        toks = rng.integers(0, cfg.vocab_size, (batch, S + STEPS),
                            dtype=np.int32)
        jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])})
        if cfg.family == "hybrid":
            dc = JM.init_decode_cache(jcfg, batch, MAX_LEN)
            for n in ("k", "v"):
                dc[n] = dc[n].at[:, :, :S].set(jc[n])
            dc["ssm"] = jc["ssm"]
            jc = dc
        out = [np.asarray(jl)]
        for i in range(STEPS):
            pos = jnp.full((batch,), S + 1 + i, jnp.int32)
            lg, jc = JM.decode_step(jcfg, jp,
                                    jnp.asarray(toks[:, S + i:S + i + 1]),
                                    jc, pos)
            out.append(np.asarray(lg))
        _REF[(arch, batch)] = (toks, out)
    return _REF[(arch, batch)]


def _close(got, want):
    got = got.numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


def _state(cfg, cache):
    """The state leaves of a decode cache, by ``state_layout``'s paths."""
    tree = {"ssm": cache["ssm"]} if cfg.family == "hybrid" else cache
    out = {}
    for key, node in tree.items():
        if key == "ssm":
            out[(key,)] = node
        elif node is not None:
            out.update({(key, str(i)): leaf for i, leaf in enumerate(node)})
    return out


def check_layout(cfg, cache, mesh, batch):
    """Each state leaf as ``cache_shardings`` lays it out on replica 0: a
    leaf split over model is one part a shard on the shard's device, its
    split dim / model; any other leaf one tensor on the controller; the
    batch dim / data when the data axes divide it.  Returns the number of
    leaves split over model."""
    whole = M.init_decode_cache(cfg, batch, MAX_LEN, device="meta")
    want = _state(cfg, whole)
    state = _state(cfg, cache)
    assert state.keys() == want.keys()
    _, dsize, ax = sh._data_size(mesh)
    tp = mesh.shape["model"]
    row = mesh.replica(0).devices
    split = 0
    for path, leaf in want.items():
        spec = sh.cache_shardings(cfg, {path[-1]: leaf}, mesh,
                                  batch)[path[-1]]
        shape = list(leaf.shape)
        if ax in spec and dsize > 1:
            shape[spec.index(ax)] //= dsize
        got = state[path]
        if "model" in spec:
            shape[spec.index("model")] //= tp
            assert isinstance(got, tuple) and len(got) == tp, path
            for part, dev in zip(got, row):
                assert (tuple(part.shape), part.device) == (tuple(shape),
                                                            dev), path
            split += 1
        else:
            assert isinstance(got, torch.Tensor), path
            assert (tuple(got.shape), got.device) == (tuple(shape),
                                                      row[0]), path
    return split


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,batch", MESHES,
                         ids=[f"{m[0]}x{m[1]}-b{b}" for m, b in MESHES])
def test_prefill_then_decode_match_jax(arch, shape, batch):
    _, _, cfg, params = _setup(arch)
    toks, want = _reference(arch, batch)
    mesh = make_debug_mesh(*shape, device="cpu")
    rows = batch // shape[0] if batch % shape[0] == 0 else batch
    assert sh.state_layout(cfg, mesh, batch).rows == rows
    tree = M.with_slices(sh.place_train(params, cfg, mesh), 0,
                         sh.train_dims(cfg, mesh))
    with torch.no_grad():
        logits, cache = M.replica_prefill(
            cfg, tree, {"tokens": torch.as_tensor(toks[:, :S])}, mesh=mesh,
            max_len=MAX_LEN)
        _close(logits, want[0][:rows])
        # every leaf the spec names splits: all of xLSTM's but m, and ssm
        n = 7 if cfg.family == "ssm" else 1
        assert check_layout(cfg, cache, mesh, batch) == n
        for i in range(STEPS):
            got = M.replica_decode_step(
                cfg, tree, torch.as_tensor(toks[:rows, S + i:S + i + 1]),
                cache, torch.full((rows,), S + 1 + i, dtype=torch.int32),
                mesh=mesh)
            _close(got, want[i + 1][:rows])
            assert check_layout(cfg, cache, mesh, batch) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_the_split_step_equals_the_whole_one(arch):
    """Over one (1, 4) mesh, the decode from a prefill's state split over
    the shards against the same steps over that state whole on the
    controller (a ``ServingMesh`` of the same devices): the logits within
    LOGIT_RTOL x max |logit| (the n . q sum and the gathers change f32
    association only), and the states gathered whole within 1e-5 of
    their largest entry."""
    _, _, cfg, params = _setup(arch)
    toks, _ = _reference(arch, 1)
    mesh = make_debug_mesh(1, 4, device="cpu")
    tree = M.with_slices(sh.place_train(params, cfg, mesh), 0,
                         sh.train_dims(cfg, mesh))
    out = {}
    with torch.no_grad():
        for name, m in (("split", mesh), ("whole", mesh.replica(0))):
            _, cache = M.replica_prefill(
                cfg, tree, {"tokens": torch.as_tensor(toks[:, :S])}, mesh=m,
                max_len=MAX_LEN)
            logits = [M.replica_decode_step(
                cfg, tree, torch.as_tensor(toks[:, S + i:S + i + 1]), cache,
                torch.tensor([S + 1 + i], dtype=torch.int32), mesh=m)
                for i in range(STEPS)]
            out[name] = (logits, _state(cfg, cache))
    lay = sh.state_layout(cfg, mesh, 1)
    for a, b in zip(out["split"][0], out["whole"][0]):
        _close(a, b.numpy())
    for path, whole in out["whole"][1].items():
        got = out["split"][1][path]
        if isinstance(got, tuple):
            got = torch.cat(got, dim=lay.dims[path])
        tol = 1e-5 * max(1.0, float(whole.abs().max()))
        assert float((got.float() - whole.float()).abs().max()) <= tol, path


@pytest.mark.parametrize("arch", ARCHS)
def test_each_card_steps_its_part_on_a_fake_mesh(arch):
    """The compile analysis's decode step over a (2, 4) mesh of fake
    cards, each card its own device, at a batch the data axes divide
    (each replica its rows) and at a batch of 1: every state leaf's parts
    on replica 0's cards in ``cache_shardings``' shard shapes, before and
    after the step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_reduced(arch)
    mesh = dryrun.fake_mesh(2, 4, whole=True)
    for batch in (4, 1):
        info = dict(kind="decode", seq=MAX_LEN, batch=batch)
        with FakeTensorMode():
            fn, args, _, _ = specs.input_specs(cfg, info, mesh)
            cache = args[2]
            n = check_layout(cfg, cache, mesh, batch)
            fn(*args)
            assert check_layout(cfg, cache, mesh, batch) == n
        assert n == (7 if cfg.family == "ssm" else 1)


def test_the_batch_dim_takes_the_data_axes_at_production_batches():
    """The rule's batch search takes the first dim equal to the batch
    (the reference's, copied); at the production batches (decode_32k's
    128, long_500k's 1) on the (16, 16) mesh that is every xLSTM leaf's
    batch dim, and a batch equal to a lead dim the data axes divide (6
    periods of 8 blocks) is refused rather than stepped wrong."""
    cfg = get_config("xlstm-1.3b")
    mesh = dryrun.fake_mesh(16, 16)
    state = M.init_decode_cache(cfg, 128, 0, device="meta")
    for key, group in state.items():
        for i, leaf in enumerate(group):
            spec = sh.cache_shardings(cfg, {str(i): leaf}, mesh, 128)[str(i)]
            bdim = leaf.ndim - (4 if (key, i) == ("mlstm", 0) else
                                2 if (key, i) == ("mlstm", 2) else 3)
            assert leaf.shape[bdim] == 128
            assert spec.index("data") == bdim, (key, i, spec)
    assert sh.state_layout(cfg, mesh, 128).rows == 8
    assert sh.state_layout(cfg, mesh, 1).rows == 1
    six = make_debug_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="not on its batch dim"):
        sh.state_layout(cfg, six, 6)


# the recurrent state on the busiest card of replica 0, decode_32k /
# long_500k: xLSTM's split leaves' shares plus mLSTM's m on the
# controller; Hymba's ssm share
STATE_BYTES = {("xlstm-1.3b", "decode_32k"): 353_285_376,
               ("xlstm-1.3b", "long_500k"): 44_160_672,
               ("hymba-1.5b", "decode_32k"): 1_638_400,
               ("hymba-1.5b", "long_500k"): 204_800}


@pytest.mark.parametrize("arch,shape", list(STATE_BYTES),
                         ids=[f"{a}-{s}" for a, s in STATE_BYTES])
def test_state_bytes_on_the_busiest_card_of_the_production_mesh(arch, shape):
    fig = dryrun.cache_figures(get_config(arch), shape,
                               dryrun.fake_mesh(16, 16))
    assert fig["state_bytes"] == STATE_BYTES[(arch, shape)]
    assert fig["cache_bytes"] == fig["kv_cache_bytes"] + fig["state_bytes"]
