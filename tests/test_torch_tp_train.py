"""A training step on a ``(data, model)`` mesh of CPU shards
(``launch/mesh.py::make_debug_mesh(..., device="cpu")``), in the training
layout of ``launch/sharding.py::place_train``: Megatron row sums of
wo/wd, the batch split over the data axis, ZeRO-1 moments.

Against JAX, in f32 at reduced size, for the dense (Qwen2), VLM
(InternVL2) and MoE (Mixtral) families on (1, 2), (2, 1) and (2, 2)
meshes, and on the (2, 4) debug mesh a Qwen2 of 14 heads (3.5 a shard:
the ragged case): the loss within 1e-5 relative of
``jax.value_and_grad(repro.training.train_lib.loss_fn)`` and every grad
leaf within ``1e-4 * max|g_jax| + 1e-6``.  Within the port, three steps:
each step's loss and grads equal the one-device step's at the mesh's own
params to the same tolerance, its ZeRO-1 update equals ``apply_updates``
on the same inputs, m and v on each device have ``opt_spec``'s shard
shape, and the params are bit-identical across data replicas.
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
from repro.training.train_lib import loss_fn as jax_loss_fn
from repro_torch.configs import get_reduced
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M
from repro_torch.training import optimizer as O
from repro_torch.training import train_lib as TL

LOSS_RTOL = 1e-5
SEQ_CHUNK = 16
# Qwen2 reduced with its 14 heads: 224 fused q columns split 56 a shard over
# 4, three and a half heads (the reference's param_spec still splits them)
RAGGED = dict(n_heads=14, n_kv_heads=2, head_dim=16)
CASES = [
    ("qwen2-0.5b", {}, (1, 2)),
    ("qwen2-0.5b", {}, (2, 1)),
    ("qwen2-0.5b", {}, (2, 2)),
    ("internvl2-1b", {}, (1, 2)),
    ("internvl2-1b", {}, (2, 1)),
    ("internvl2-1b", {}, (2, 2)),
    ("mixtral-8x7b", {}, (1, 2)),
    ("mixtral-8x7b", {}, (2, 1)),
    ("mixtral-8x7b", {}, (2, 2)),
    ("mixtral-8x7b", {"moe_experts": 3}, (2, 2)),
    ("qwen2-0.5b", RAGGED, (2, 4)),
]
IDS = [f"{a}{'-' + '-'.join(f'{k}{v}' for k, v in o.items()) if o else ''}"
       f"-{d}x{m}" for a, o, (d, m) in CASES]


def grad_tol(g_ref):
    return 1e-4 * float(np.max(np.abs(g_ref))) + 1e-6


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed, B=4, S=32):
    """numpy batch; the loss mask differs between the batch's halves, so a
    mean of per-replica means would be wrong."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    mask = (rng.random((B, S)) < np.linspace(0.9, 0.3, B)[:, None])
    out = {"labels": rng.integers(0, V, (B, S), dtype=np.int32),
           "loss_mask": mask.astype(np.float32)}
    if cfg.family == "vlm":
        vt = cfg.vision_tokens
        out["tokens"] = rng.integers(0, V, (B, S - vt), dtype=np.int32)
        out["patch_embeds"] = (0.02 * rng.standard_normal(
            (B, vt, cfg.d_model))).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, V, (B, S), dtype=np.int32)
    return out


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


_JAX = {}


def _setup(arch, over):
    """(cfg, params, batch, JAX loss, JAX grads flat), cached."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _JAX:
        jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32", **over)
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **over)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
        params = M.params_from_numpy(_flat(jp), cfg)
        batch = _batch(cfg, seed=5)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jax_loss_fn(jcfg, p, jb, seq_chunk=SEQ_CHUNK)))(jp)
        _JAX[key] = (cfg, params, batch, float(jl), _flat(jg))
    return _JAX[key]


def _summed(cfg, mesh, grads):
    """The replicas' grads summed and gathered into one flat tree."""
    whole = [M.params_to_numpy(sh.gather_train(g, cfg, mesh)) for g in grads]
    return {k: sum(w[k] for w in whole) for k in whole[0]}


@pytest.mark.parametrize("arch,over,shape", CASES, ids=IDS)
def test_sharded_loss_and_grads_match_jax(arch, over, shape):
    cfg, params, batch, jl, jg = _setup(arch, over)
    mesh = make_debug_mesh(*shape, device="cpu")
    loss, grads = TL.sharded_loss_and_grads(
        cfg, sh.place_train(params, cfg, mesh), _torch(batch), mesh,
        seq_chunk=SEQ_CHUNK)
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl), (float(loss), jl)
    assert len(grads) == shape[0]
    tg = _summed(cfg, mesh, grads)
    assert sorted(tg) == sorted(jg)
    for key, g_ref in jg.items():
        err = float(np.max(np.abs(tg[key] - g_ref)))
        assert err <= grad_tol(g_ref), (key, err, grad_tol(g_ref))


def _shards(leaf):
    return leaf if isinstance(leaf, tuple) else (leaf,)


def _check_zero_shapes(cfg, mesh, params, state):
    """Each device's m and v: opt_spec's shard shape, on the param
    shard's device."""
    dims = sh.train_dims(cfg, mesh)
    n, tp = mesh.shape["data"], mesh.shape["model"]
    logical = dict(sh._leaves(M.init_params(cfg, 0, device="meta")))
    for d in range(n):
        ps, ms, vs = (dict(sh._leaves(t[d]))
                      for t in (params, state.m, state.v))
        for path, leaf in logical.items():
            spec = sh.opt_spec(sh.param_spec(path, leaf, cfg, mesh), leaf,
                               mesh)
            want = [s // (tp if a == "model" else n if a else 1)
                    for s, a in zip(leaf.shape, spec)]
            assert (dims[path][1] >= 0) == ("data" in spec)
            for p, m, v in zip(_shards(ps[path]), _shards(ms[path]),
                               _shards(vs[path])):
                assert list(m.shape) == list(v.shape) == want, path
                assert m.device == v.device == p.device


@pytest.mark.parametrize("arch,over,shape", [
    ("qwen2-0.5b", {}, (2, 2)), ("internvl2-1b", {}, (2, 2)),
    ("mixtral-8x7b", {}, (2, 2)), ("qwen2-0.5b", RAGGED, (2, 4))],
    ids=["qwen2-2x2", "internvl2-2x2", "mixtral-2x2", "qwen2-ragged-2x4"])
def test_three_steps_match_the_one_device_step(arch, over, shape):
    cfg, params, _, _, _ = _setup(arch, over)
    mesh = make_debug_mesh(*shape, device="cpu")
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=1)
    step = TL.make_train_step(cfg, opt, mesh=mesh)
    placed = sh.place_train(params, cfg, mesh)
    dims = sh.train_dims(cfg, mesh)
    state = O.init_state_zero(dims, placed, mesh)
    one, one_state = params, O.init_state(params)
    one_step = TL.make_train_step(cfg, opt)
    for i in range(3):
        batch = _torch(_batch(cfg, seed=10 + i))
        _check_zero_shapes(cfg, mesh, placed, state)
        # the one-device step at the mesh's own params and moments
        here = sh.gather_train(placed, cfg, mesh)
        m = O.gather_moments(dims, mesh, state.m)
        v = O.gather_moments(dims, mesh, state.v)
        want_loss, want_g = TL.loss_and_grads(cfg, here, batch)
        loss, grads = TL.sharded_loss_and_grads(cfg, placed, batch, mesh)
        assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
            float(want_loss))
        got_g = _summed(cfg, mesh, grads)
        for key, g_ref in M.params_to_numpy(want_g).items():
            err = float(np.max(np.abs(got_g[key] - g_ref)))
            assert err <= grad_tol(g_ref), (i, key, err)
        new, state, metrics = step(placed, state, batch)
        ref, _, ref_norm = O.apply_updates(
            opt, here, sh.gather_train(
                [M.params_from_numpy(got_g, cfg)], cfg, mesh),
            O.AdamWState(step=state.step - 1, m=m, v=v))
        assert float(metrics["loss"]) == float(loss)
        assert abs(float(metrics["grad_norm"]) - float(ref_norm)) <= \
            1e-5 * float(ref_norm)
        upd = sh.gather_train(new, cfg, mesh)
        for path, r in sh._leaves(ref):
            err = float((dict(sh._leaves(upd))[path] - r).abs().max())
            assert err <= 1e-5 * float(r.abs().max()) + 1e-7, (i, path, err)
        # every data replica holds the same bits
        for d in range(1, shape[0]):
            for (path, a), (_, b) in zip(sh._leaves(new[0]),
                                         sh._leaves(new[d])):
                assert all(torch.equal(x, y) for x, y in
                           zip(_shards(a), _shards(b))), (i, path)
        placed = new
        # the one-device trajectory keeps the loss
        one, one_state, one_m = one_step(one, one_state, batch)
        assert abs(float(one_m["loss"]) - float(metrics["loss"])) <= \
            LOSS_RTOL * abs(float(one_m["loss"]))


def test_the_loss_is_the_global_masked_mean():
    """The replicas' masks hold different counts: the step's loss is the
    whole batch's masked mean, not the mean of the replicas' means."""
    cfg, params, batch, jl, _ = _setup("qwen2-0.5b", {})
    mesh = make_debug_mesh(2, 1, device="cpu")
    placed = sh.place_train(params, cfg, mesh)
    loss, _ = TL.sharded_loss_and_grads(cfg, placed, _torch(batch), mesh,
                                        seq_chunk=SEQ_CHUNK)
    halves = [{k: v[2 * d:2 * d + 2] for k, v in _torch(batch).items()}
              for d in range(2)]
    means = [float(TL.loss_fn(cfg, params, h, seq_chunk=SEQ_CHUNK))
             for h in halves]
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl)
    assert abs(sum(means) / 2 - jl) > 100 * abs(float(loss) - jl) + 1e-5


def test_unsplit_batch_runs_on_replica_0():
    """A batch the data axis does not divide (the reference replicates it,
    every replica computing the same grads) runs whole on replica 0; the
    loss is still the whole batch's."""
    mesh = make_debug_mesh(2, 2, device="cpu")
    cfg, params, batch, _, _ = _setup("qwen2-0.5b", {})
    odd = {k: v[:3] for k, v in _torch(batch).items()}
    loss, grads = TL.sharded_loss_and_grads(cfg, sh.place_train(
        params, cfg, mesh), odd, mesh, seq_chunk=SEQ_CHUNK)
    assert len(grads) == 1
    assert abs(float(loss) - float(TL.loss_fn(cfg, params, odd,
                                              seq_chunk=SEQ_CHUNK))) <= 1e-6


def test_capacity_dispatch_trains_on_one_data_replica():
    """A capacity-dispatch MoE, whose reference dispatch fills the
    experts' buffers from the whole batch, trains on a (1, 2) mesh as JAX
    does; on a data axis over 1 the replicas dispatch their rows into the
    whole batch's slots (models/model.py::CapacityDispatch), and the
    step, built for such a mesh, matches JAX too."""
    cfg, params, batch, jl, jg = _setup("mixtral-8x7b",
                                        {"moe_impl": "capacity"})
    mesh = make_debug_mesh(1, 2, device="cpu")
    loss, grads = TL.sharded_loss_and_grads(cfg, sh.place_train(
        params, cfg, mesh), _torch(batch), mesh, seq_chunk=SEQ_CHUNK)
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl)
    tg = _summed(cfg, mesh, grads)
    for key, g_ref in jg.items():
        assert float(np.max(np.abs(tg[key] - g_ref))) <= grad_tol(g_ref), key
    for shape in ((2, 1), (2, 2)):
        wide = make_debug_mesh(*shape, device="cpu")
        loss, grads = TL.sharded_loss_and_grads(
            cfg, sh.place_train(params, cfg, wide), _torch(batch), wide,
            seq_chunk=SEQ_CHUNK)
        assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl), shape
        tg = _summed(cfg, wide, grads)
        for key, g_ref in jg.items():
            assert float(np.max(np.abs(tg[key] - g_ref))) <= \
                grad_tol(g_ref), (shape, key)
        placed = sh.place_train(params, cfg, wide)
        state = O.init_state_zero(sh.train_dims(cfg, wide), placed, wide)
        _, _, m = TL.make_train_step(cfg, O.AdamWConfig(), mesh=wide)(
            placed, state, _torch(batch))
        assert float(m["loss"]) == float(loss)


def test_global_norm_counts_a_shared_leaf_once():
    a, b = torch.tensor([3.0]), torch.tensor([4.0])
    assert float(O.global_norm({"x": a, "y": b})) == 5.0
    assert float(O.global_norm([{"x": a, "y": b}, {"x": a}])) == 5.0
    assert float(O.global_norm([(a, b), a])) == 5.0


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b",
                                  "musicgen-large"])
def test_recurrent_and_audio_families_under_a_mesh_raise(arch):
    """The recurrent and audio families no longer raise under a mesh: on a
    (2, 2) mesh their loss and every grad leaf match JAX's (the one-shard
    forward's tree as the reference), and one step keeps every data
    replica's params identical (tests/test_torch_mesh_families.py holds
    them on every mesh shape)."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    params = M.params_from_numpy(_flat(jp), cfg)
    rng = np.random.default_rng(5)
    shape = (4, cfg.n_codebooks, 32) if cfg.n_codebooks else (4, 32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jb, seq_chunk=SEQ_CHUNK)))(jp)
    mesh = make_debug_mesh(2, 2, device="cpu")
    placed = sh.place_train(params, cfg, mesh)
    loss, grads = TL.sharded_loss_and_grads(cfg, placed, _torch(batch), mesh,
                                            seq_chunk=SEQ_CHUNK)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    tg = _summed(cfg, mesh, grads)
    for key, g_ref in _flat(jg).items():
        err = float(np.max(np.abs(tg[key] - g_ref)))
        assert err <= grad_tol(g_ref), (key, err)
    state = O.init_state_zero(sh.train_dims(cfg, mesh), placed, mesh)
    new, _, _ = TL.make_train_step(cfg, O.AdamWConfig(), mesh=mesh)(
        placed, state, _torch(batch))
    for (path, a), (_, b) in zip(sh._leaves(new[0]), sh._leaves(new[1])):
        assert all(torch.equal(x, y) for x, y in
                   zip(_shards(a), _shards(b))), path
