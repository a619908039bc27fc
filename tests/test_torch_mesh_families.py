"""The recurrent (xLSTM, Hymba), audio (MusicGen) and capacity-dispatch MoE
families on a ``(data, model)`` mesh of CPU shards, against JAX.

Training (``train_lib.sharded_loss_and_grads``) on (1, 2), (2, 1) and
(2, 2) meshes: the loss within 1e-5 relative of
``jax.value_and_grad(repro.training.train_lib.loss_fn)`` and every grad
leaf within ``1e-4 * max|g_jax| + 1e-6`` (``tests/test_torch_tp_train.py``'s
tolerances), in f32 at reduced size.  The capacity MoE's batch of 4 x 32
tokens is one dispatch chunk that straddles both data replicas, so its
slots are the whole batch's (``models/model.py::CapacityDispatch``).

The reference's prefill and decode step in the training layout
(``model.replica_prefill`` / ``replica_decode_step``, the compile
analysis's steps) on a (1, 2) mesh against ``repro.models.model.prefill``
and ``decode_step``: last-token logits within 1e-5 of max |logit|, and
the decode cache's new rows.
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
LOGIT_RTOL = 1e-5
FAMILIES = ["xlstm-1.3b", "hymba-1.5b", "musicgen-large"]
MESHES = [(1, 2), (2, 1), (2, 2)]


def grad_tol(g_ref):
    return 1e-4 * float(np.max(np.abs(g_ref))) + 1e-6


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed, B=4, S=32):
    """numpy batch, codebook tokens (B, K, S) for MusicGen; the loss mask
    differs between the batch's halves."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    frac = np.linspace(0.9, 0.3, B).reshape((B,) + (1,) * (len(shape) - 1))
    return {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
            "loss_mask": (rng.random(shape) < frac).astype(np.float32)}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


_JAX = {}


def _setup(arch, over=()):
    key = (arch, over)
    if key not in _JAX:
        jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32",
                                   **dict(over))
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                                  **dict(over))
        jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
        params = M.params_from_numpy(_flat(jp), cfg)
        batch = _batch(cfg, seed=5)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jax_loss_fn(jcfg, p, jb, seq_chunk=SEQ_CHUNK)))(jp)
        _JAX[key] = (jcfg, jp, cfg, params, batch, float(jl), _flat(jg))
    return _JAX[key]


def _check_grads(cfg, mesh, loss, grads, jl, jg):
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl), (float(loss), jl)
    whole = [M.params_to_numpy(sh.gather_train(g, cfg, mesh)) for g in grads]
    tg = {k: sum(w[k] for w in whole) for k in whole[0]}
    assert sorted(tg) == sorted(jg)
    for key, g_ref in jg.items():
        err = float(np.max(np.abs(tg[key] - g_ref)))
        assert err <= grad_tol(g_ref), (key, err, grad_tol(g_ref))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_trains_on_a_mesh_as_jax(arch, shape):
    _, _, cfg, params, batch, jl, jg = _setup(arch)
    mesh = make_debug_mesh(*shape, device="cpu")
    loss, grads = TL.sharded_loss_and_grads(
        cfg, sh.place_train(params, cfg, mesh), _torch(batch), mesh,
        seq_chunk=SEQ_CHUNK)
    assert len(grads) == shape[0]
    _check_grads(cfg, mesh, loss, grads, jl, jg)


CAPACITY = (("moe_impl", "capacity"),)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_capacity_dispatch_across_data_replicas_as_jax(shape):
    _, _, cfg, params, batch, jl, jg = _setup("mixtral-8x7b", CAPACITY)
    mesh = make_debug_mesh(*shape, device="cpu")
    loss, grads = TL.sharded_loss_and_grads(
        cfg, sh.place_train(params, cfg, mesh), _torch(batch), mesh,
        seq_chunk=SEQ_CHUNK)
    _check_grads(cfg, mesh, loss, grads, jl, jg)


def test_capacity_chunks_that_do_not_straddle():
    """With a dispatch chunk of one replica's tokens each replica fills
    its own chunks: the step equals the one-device step's, and no counts
    cross replicas."""
    _, _, cfg, params, batch, _, _ = _setup("mixtral-8x7b", CAPACITY)
    mesh = make_debug_mesh(2, 1, device="cpu")
    from repro_torch.models import layers as L
    orig = L.moe_capacity_with

    def small(*a, **kw):
        return orig(*a, **dict(kw, token_chunk=64))
    L.moe_capacity_with = small
    try:
        want, _ = TL.loss_and_grads(cfg, params, _torch(batch),
                                    seq_chunk=SEQ_CHUNK)
        loss, _ = TL.sharded_loss_and_grads(
            cfg, sh.place_train(params, cfg, mesh), _torch(batch), mesh,
            seq_chunk=SEQ_CHUNK)
    finally:
        L.moe_capacity_with = orig
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))


def _prefill_inputs(cfg, seed=7, B=2, S=24):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    return rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)


@pytest.mark.parametrize("arch", FAMILIES + ["qwen2-0.5b", "mixtral-8x7b"])
def test_replica_prefill_and_decode_match_jax(arch):
    jcfg, jp, cfg, params, _, _, _ = _setup(arch)
    mesh = make_debug_mesh(1, 2, device="cpu")
    placed = sh.place_train(params, cfg, mesh)[0]
    row = mesh.replica(0)
    toks = _prefill_inputs(cfg)
    jl, jcache = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tcache = M.replica_prefill(cfg, placed, {"tokens": torch.as_tensor(
            toks)}, mesh=row)
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    scale = float(np.abs(jl).max())
    assert float(np.abs(tl.numpy() - jl).max()) <= LOGIT_RTOL * scale
    if cfg.family != "ssm":
        k = tcache["k"]
        k = torch.cat(k, dim=3) if isinstance(k, tuple) else k
        assert float(np.abs(k.numpy() - np.asarray(jcache["k"])).max()) \
            <= 1e-5
    # one decode step at position 1 over a fresh cache
    B, S = toks.shape[0], 8
    tok = toks[..., :1]
    pos = np.ones((B,), np.int32)
    jc = JM.init_decode_cache(jcfg, B, S)
    jdl, _ = JM.decode_step(jcfg, jp, jnp.asarray(tok), jc, jnp.asarray(pos))
    cache = M.replica_decode_cache(cfg, B, S, params=placed, mesh=row)
    with torch.no_grad():
        tdl = M.replica_decode_step(cfg, placed, torch.as_tensor(tok), cache,
                                    torch.as_tensor(pos), mesh=row)
    jdl = np.asarray(jdl)
    assert float(np.abs(tdl.numpy() - jdl).max()) <= \
        LOGIT_RTOL * float(np.abs(jdl).max())


def test_family_steps_keep_replicas_identical():
    """Two AdamW steps of Hymba on a (2, 2) mesh: the loss equals the
    one-device step's and every data replica holds the same param bits."""
    _, _, cfg, params, batch, _, _ = _setup("hymba-1.5b")
    mesh = make_debug_mesh(2, 2, device="cpu")
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=1)
    placed = sh.place_train(params, cfg, mesh)
    state = O.init_state_zero(sh.train_dims(cfg, mesh), placed, mesh)
    step = TL.make_train_step(cfg, opt, mesh=mesh)
    one, one_state = params, O.init_state(params)
    one_step = TL.make_train_step(cfg, opt)
    for _ in range(2):
        placed, state, m = step(placed, state, _torch(batch))
        one, one_state, m1 = one_step(one, one_state, _torch(batch))
        assert abs(float(m["loss"]) - float(m1["loss"])) <= \
            LOSS_RTOL * abs(float(m1["loss"]))
        for (path, a), (_, b) in zip(sh._leaves(placed[0]),
                                     sh._leaves(placed[1])):
            pa = a if isinstance(a, tuple) else (a,)
            pb = b if isinstance(b, tuple) else (b,)
            assert all(torch.equal(x, y) for x, y in zip(pa, pb)), path


def test_mlstm_chunkwise_backward_is_finite_past_the_overflow():
    """Over a 256-step chunk the masked upper triangle's weights overflow
    in f32; the chunkwise form's gradients stay finite and equal the
    recurrent form's (the oracle), as its outputs do."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    B, S, H, hd = 1, 256, 2, 8
    ins = [torch.randn(B, S, H, hd, generator=g) for _ in range(3)]
    ins += [torch.randn(B, S, H, generator=g),
            torch.randn(B, S, H, generator=g) - 4.0]
    grads = []
    for fn in (L.mlstm_chunkwise, L.mlstm_scan):
        live = [t.clone().requires_grad_(True) for t in ins]
        h, _ = fn(*live)
        grads.append(torch.autograd.grad(h.square().sum(), live))
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) \
            + 1e-5
