"""The port's training path against the JAX package's, on the CPU in f32
at reduced size: ``models.model.forward``/``forward_hidden``, the flash
backward (``layers.flash_attention_bwd`` behind ``layers.flash_attention``),
``training.{optimizer,train_lib,checkpoint,data}`` and ``launch/train.py``.

Params cross through ``params_from_numpy``; inputs come from numpy seeds.
The loss must lie within 1e-5 (relative) of ``repro.training.train_lib.
loss_fn``'s and every gradient leaf within ``1e-4 * max|g_jax| + 1e-6`` of
``jax.value_and_grad``'s, for one arch of each family (Gemma2 adds the
softcaps and a binding window).  The recurrent families' sequences stay
under ~100 tokens: the reference's ``mlstm_chunkwise`` gives NaN past
~128 steps of one chunk (ROADMAP.md Queue C).  The twins of
``tests/test_training.py`` and of ``tests/test_arch_smoke.py::
test_train_step_smoke`` follow.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import checkpoint as jax_ckpt
from repro.training import optimizer as JO
from repro.training.train_lib import loss_fn as jax_loss_fn
from repro_torch.configs import get_reduced, list_configs
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as O
from repro_torch.training.data import DataConfig, make_batches
from repro_torch.training.train_lib import (loss_and_grads, loss_fn,
                                            make_train_step)

FAMILY_ARCHS = ["qwen2-0.5b", "mixtral-8x7b", "internvl2-1b", "xlstm-1.3b",
                "hymba-1.5b", "musicgen-large", "gemma2-27b"]
LOSS_RTOL = 1e-5
SEQ = {"gemma2-27b": 80}            # past its 64-token window
SEQ_CHUNK = 16


def grad_tol(g_ref):
    return 1e-4 * float(np.max(np.abs(g_ref))) + 1e-6


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed, B=2, S=40):
    """numpy batch {"tokens", "labels"[, "patch_embeds", "loss_mask"]}."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    if cfg.n_codebooks:
        toks = rng.integers(0, V, (B, cfg.n_codebooks, S), dtype=np.int32)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}
    if cfg.family == "vlm":
        vt = cfg.vision_tokens
        return {"tokens": rng.integers(0, V, (B, S - vt), dtype=np.int32),
                "patch_embeds": (0.02 * rng.standard_normal(
                    (B, vt, cfg.d_model))).astype(np.float32),
                "labels": rng.integers(0, V, (B, S), dtype=np.int32),
                "loss_mask": np.concatenate(
                    [np.zeros((B, vt)), np.ones((B, S - vt))],
                    axis=1).astype(np.float32)}
    toks = rng.integers(0, V, (B, S), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}


def _torch_batch(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _f32(arch):
    return (dataclasses.replace(jax_reduced(arch), dtype="float32"),
            dataclasses.replace(get_reduced(arch), dtype="float32"))


_CASES = {}


def _case(arch):
    """(JAX loss, JAX grads flat, port loss, port grads flat), cached."""
    if arch not in _CASES:
        jcfg, cfg = _f32(arch)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
        params = M.params_from_numpy(_flat(jp), cfg)
        batch = _batch(cfg, seed=5, S=SEQ.get(arch, 40))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jl, jg = jax.value_and_grad(
            lambda p: jax_loss_fn(jcfg, p, jb, seq_chunk=SEQ_CHUNK))(jp)
        loss, grads = loss_and_grads(cfg, params, _torch_batch(batch),
                                     seq_chunk=SEQ_CHUNK)
        _CASES[arch] = (float(jl), _flat(jg), float(loss),
                        M.params_to_numpy(grads))
    return _CASES[arch]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_matches_jax(arch):
    jl, _, tl, _ = _case(arch)
    assert np.isfinite(jl) and np.isfinite(tl)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (arch, tl, jl)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_grads_match_jax(arch):
    _, jg, _, tg = _case(arch)
    assert sorted(jg) == sorted(tg)
    for key, g_ref in jg.items():
        d = float(np.max(np.abs(tg[key].astype(np.float64) - g_ref)))
        assert d <= grad_tol(g_ref), (arch, key, d, grad_tol(g_ref))


# (prefix, window, softcap, KV heads of 4): GQA, windows binding across the
# 512-chunk edges, a cached prefix (q_offset), the softcap's derivative
FLASH_CASES = [(0, 0, 0.0, 2), (0, 200, 0.0, 2), (0, 0, 30.0, 4),
               (100, 150, 20.0, 1), (0, 700, 50.0, 2)]


@pytest.mark.parametrize("prefix,window,cap,kv", FLASH_CASES)
def test_flash_backward_matches_jax(prefix, window, cap, kv):
    """``flash_attention``'s autograd against ``jax.vjp`` of the
    reference's ``_flash`` custom VJP, two 512-row chunks of queries."""
    rng = np.random.default_rng(11)
    B, Sq, H, hd = 2, 600, 4, 32
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, prefix + Sq, kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, prefix + Sq, kv, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    jo, vjp = jax.vjp(lambda a, b, c: JL.flash_attention(
        a, b, c, q_offset=prefix, window=window, logit_cap=cap),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = L.flash_attention(tq, tk, tv, q_offset=prefix, window=window,
                          logit_cap=cap)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
    assert np.max(np.abs(o.detach().numpy() - np.asarray(jo))) <= 1e-5
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        d = float(np.max(np.abs(g.numpy().astype(np.float64) - w)))
        assert d <= grad_tol(w), (name, d, grad_tol(w))


def test_flash_forward_keeps_the_serve_bits():
    """With autograd recording, the forward is the same dispatch: its
    output equals the no-grad call's bit for bit."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.standard_normal((1, 70, 4, 16)),
                            dtype=torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        ref = L.flash_attention(q, k[:, :, :2], v[:, :, :2], window=30)
    live = L.flash_attention(q.requires_grad_(True), k[:, :, :2],
                             v[:, :, :2], window=30)
    assert live.requires_grad
    assert torch.equal(live.detach(), ref)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b"])
def test_forward_matches_jax(arch):
    jcfg, cfg = _f32(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(4))
    params = M.params_from_numpy(_flat(jp), cfg)
    batch = _batch(cfg, seed=6)
    want = np.asarray(JM.forward(jcfg, jp, {"tokens": jnp.asarray(
        batch["tokens"])}))
    with torch.no_grad():
        got = M.forward(cfg, params, {"tokens": torch.as_tensor(
            batch["tokens"])}).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-4


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 3, 2)}}

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict) else
                (scale * rng.standard_normal(v)).astype(np.float32)
                for k, v in tree.items()}
    return draw(shapes, 1.0), draw(shapes, 3.0)


def test_apply_updates_matches_jax():
    """Three AdamW steps (clipped: the grads' norm is past 1) on a tree
    with vectors and matrices: params, moments and grad norm within
    1e-6."""
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    p, g = _opt_inputs()
    jp = jax.tree.map(jnp.asarray, p)
    jg = jax.tree.map(jnp.asarray, g)
    tp = O.tree_map(torch.as_tensor, p)
    tg = O.tree_map(torch.as_tensor, g)
    js, ts = JO.init_state(jp), O.init_state(tp)
    for _ in range(3):
        jp, js, jn = JO.apply_updates(JO.AdamWConfig(**opt), jp, jg, js)
        tp, ts, tn = O.apply_updates(O.AdamWConfig(**opt), tp, tg, ts)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(O.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    for step in range(0, 41):
        want = float(JO.schedule(JO.AdamWConfig(**cfg), jnp.asarray(step)))
        got = float(O.schedule(O.AdamWConfig(**cfg), step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-1.3b"])
def test_checkpoints_cross_frameworks(arch, tmp_path):
    """A port checkpoint restores in the JAX package, and a JAX one in the
    port (bf16 leaves through f32, as both store them)."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    params = M.init_params(cfg, 5)
    ckpt.save(str(tmp_path / "port"), params, step=11)
    jlike = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jrest, step = jax_ckpt.restore(str(tmp_path / "port"), jlike)
    assert step == 11
    want = M.params_to_numpy(params)
    got = _flat(jrest)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    jp = JM.init_params(jcfg, jax.random.PRNGKey(6))
    jax_ckpt.save(str(tmp_path / "jax"), jp, step=4)
    back, step = ckpt.restore(str(tmp_path / "jax"), params)
    assert step == 4
    flat = _flat(jp)
    for key, arr in M.params_to_numpy(back).items():
        assert np.array_equal(arr, flat[key]), key
    assert all(a.dtype == b.dtype for a, b in zip(O.tree_leaves(back),
                                                  O.tree_leaves(params)))


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg = get_reduced("qwen2-0.5b")
    params = M.init_params(cfg, 0)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    state = O.init_state(params)
    step = make_train_step(cfg, opt)
    data = make_batches(DataConfig(batch_size=8, seq_len=32,
                                   vocab_size=cfg.vocab_size), cfg)
    losses = []
    for _ in range(25):
        params, state, m = step(params, state, _torch_batch(next(data)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_chunked_loss_matches_plain():
    cfg = get_reduced("qwen2-0.5b")
    params = M.init_params(cfg, 1)
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 37)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    with torch.no_grad():
        l1 = loss_fn(cfg, params, batch, seq_chunk=8)
        logits = M.forward(cfg, params, batch)
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    assert abs(float(l1 - (lse - gold).mean())) < 1e-3


def test_schedule_shape():
    opt = O.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    assert float(O.schedule(opt, 0)) == pytest.approx(0.0)
    assert float(O.schedule(opt, 10)) == pytest.approx(1.0)
    assert float(O.schedule(opt, 100)) == pytest.approx(0.1)


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_reduced("mixtral-8x7b")
    params = M.init_params(cfg, 0)
    ckpt.save(os.path.join(tmp_path, "c"), params, step=7)
    p2, s = ckpt.restore(os.path.join(tmp_path, "c"), params)
    assert s == 7
    for a, b in zip(O.tree_leaves(params), O.tree_leaves(p2)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy())


def test_synthetic_data_learnable_structure():
    data = make_batches(DataConfig(batch_size=4, seq_len=16, vocab_size=64))
    b = next(data)
    assert b["tokens"].shape == (4, 16) and b["labels"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# twin of tests/test_arch_smoke.py::test_train_step_smoke, every port arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_configs())
def test_train_step_smoke(arch):
    cfg = get_reduced(arch)
    params = M.init_params(cfg, 1)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = O.init_state(params)
    step = make_train_step(cfg, opt)
    batch = _torch_batch(_batch(cfg, seed=1, S=24))
    params2, state2, metrics = step(params, state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(state2.step) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(O.tree_leaves(params), O.tree_leaves(params2)))
    assert all(bool(torch.isfinite(p.float()).all())
               for p in O.tree_leaves(params2))


def test_train_main_on_cpu(tmp_path, capsys):
    """``launch/train.py --device cpu``: 20 steps, the loss falls, and the
    checkpoint it writes restores."""
    logged = train.main(["--device", "cpu", "--steps", "20", "--batch", "4",
                         "--seq", "32", "--log-every", "5", "--ckpt",
                         str(tmp_path), "--ckpt-every", "20"])
    out = capsys.readouterr().out
    assert [s for s, _ in logged] == [1, 5, 10, 15, 20]
    assert logged[-1][1] < logged[0][1]
    assert "checkpointed ->" in out
    like = M.init_params(get_reduced("qwen2-0.5b"), 0)
    _, step = ckpt.restore(str(tmp_path / "step20"), like)
    assert step == 20
