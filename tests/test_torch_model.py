"""The port's paged model steps against the JAX package's on the same
params (carried across through the flat checkpoint) and the same pool.

f32: logits max abs <= 1e-4 and the pool after each step equal to JAX's to
1e-5.  bf16: logits max abs <= BF16_LOGIT_EPS.  The two frameworks round
bf16 at different points inside a layer (silu, the matmul accumulators),
so bf16 ulps reach the logits: over seeds 0-2 at the reduced config, with
|logits| up to ~2.6, the largest difference measured was 1.6e-2, one bf16
ulp at 2.  5e-2 is three such ulps: room for another seed, while a wrong
mask or head mapping moves logits by O(0.1) or more.
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
from repro.training import checkpoint
from repro_torch.configs import get_reduced
from repro_torch.models import model as M

BF16_LOGIT_EPS = 5e-2
PAGE = 16
SCRATCH = 0


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request, tmp_path_factory):
    """JAX params with random biases and norm scales (the init leaves them
    zero), written by checkpoint.save and restored on both sides."""
    dtype = request.param
    jcfg = dataclasses.replace(jax_reduced("qwen2-0.5b"), dtype=dtype)
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("ckpt") / f"qwen2_{dtype}.npz"
    checkpoint.save(str(path), jp)
    rng = np.random.default_rng(1)
    flat = dict(np.load(path))
    for key in ("blocks/bq", "blocks/bk", "blocks/bv", "blocks/ln1",
                "blocks/ln2", "final_norm"):
        flat[key] = (0.1 * rng.standard_normal(flat[key].shape)).astype(
            np.float32)
    np.savez(path, **flat)
    jp, _ = checkpoint.restore(str(path), jp)
    checkpoint.save(str(path), jp)                 # the flat dict save writes
    return dtype, jcfg, cfg, jp, dict(np.load(path))


def test_params_from_numpy_round_trip(weights):
    dtype, jcfg, cfg, jp, flat = weights
    tp = M.params_from_numpy(flat, cfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    assert len(leaves) == len(flat) - 1               # minus __step__
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        node = tp
        for part in key.split("/"):
            node = node[part]
        assert node.dtype == cfg.tdtype
        assert np.array_equal(node.float().numpy(),
                              np.asarray(jnp.asarray(leaf, jnp.float32)))


def _prefill_layout(rng, cfg, n_blocks):
    """Two ragged rows over a shared pool: row 0 has a cached 20-token doc
    (ending mid-block) and computes 11 tokens; row 1 computes 7 fresh
    tokens.  Padding tokens write into the scratch block."""
    B, Sq, T = 2, 16, 6
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.full((B, T), SCRATCH, np.int32)
    counts = np.zeros((B, T), np.int32)
    starts = np.zeros((B, T), np.int32)
    wblk = np.full((B, Sq), SCRATCH, np.int32)
    wslot = np.zeros((B, Sq), np.int32)
    cached = [free.pop(), free.pop()]
    tables[0, :2], counts[0, :2], starts[0, :2] = cached, [16, 4], [0, 16]
    new0 = free.pop()
    tables[0, 2], counts[0, 2], starts[0, 2] = new0, 11, 20
    wblk[0, :11], wslot[0, :11] = new0, np.arange(11)
    new1 = free.pop()
    tables[1, 0], counts[1, 0] = new1, 7
    wblk[1, :7], wslot[1, :7] = new1, np.arange(7)
    toks = rng.integers(0, cfg.vocab_size, (B, Sq)).astype(np.int32)
    q_start = np.array([20, 0], np.int32)
    q_len = np.array([11, 7], np.int32)
    return (toks, tables, counts, starts, q_start, q_len, wblk, wslot,
            (new0, new1))


def _pools(rng, cfg, n_blocks):
    shape = (cfg.n_layers, n_blocks, PAGE, cfg.n_kv_heads, cfg.hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(getattr(torch, dtype)) if dtype is not None else t


def _pool_close(tk, jk, dtype, tol):
    a = tk.float().numpy()[:, 1:]                 # scratch block: duplicate
    b = np.asarray(jnp.asarray(jk, jnp.float32))[:, 1:]   # writes, unordered
    if dtype == "float32":
        assert np.max(np.abs(a - b)) <= tol
    else:
        assert np.max(np.abs(a - b)) <= 2e-2


def test_prefill_then_decode_match_jax(weights):
    dtype, jcfg, cfg, jp, flat = weights
    tp = M.params_from_numpy(flat, cfg)
    rng = np.random.default_rng(2)
    n_blocks = 12
    kp, vp = _pools(rng, cfg, n_blocks)
    (toks, tables, counts, starts, q_start, q_len, wblk, wslot,
     new) = _prefill_layout(rng, cfg, n_blocks)
    ins = (toks, tables, counts, starts, q_start, q_len, wblk, wslot)

    jl, jk, jv = JM.paged_prefill_step(
        jcfg, jp, _j(toks), _j(kp, dtype), _j(vp, dtype), *map(_j, ins[1:6]),
        _j(wblk), _j(wslot), attn_impl="jnp")
    tk, tv = _t(kp, dtype), _t(vp, dtype)
    k_obj = tk
    tl = M.paged_prefill_step(cfg, tp, _t(toks).long(), [tk], [tv],
                              *map(_t, ins[1:6]), _t(wblk), _t(wslot))
    assert tk is k_obj                              # written in place
    eps = 1e-4 if dtype == "float32" else BF16_LOGIT_EPS
    assert tl.shape == (2, 1, cfg.vocab_size) and tl.dtype == torch.float32
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) <= eps
    _pool_close(tk, jk, dtype, 1e-5)
    _pool_close(tv, jv, dtype, 1e-5)

    # one decode step for both rows on top of the prefilled pool (the JAX
    # pool continues from JAX's result, the port's from its own)
    B, T = 3, tables.shape[1]
    dt = np.full((B, T), SCRATCH, np.int32)
    dc = np.zeros((B, T), np.int32)
    ds = np.zeros((B, T), np.int32)
    dt[:2], dc[:2], ds[:2] = tables, counts, starts
    dc[0, 2] += 1                                   # slot 11 of new0
    dc[1, 0] += 1                                   # slot 7 of new1
    dc[2, 0] = 1                                    # dummy row: scratch
    pos = np.array([32, 8, 1], np.int32)
    wb = np.array([new[0], new[1], SCRATCH], np.int32)
    ws = np.array([11, 7, 0], np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl2, jk2, jv2 = JM.paged_decode_step(
        jcfg, jp, _j(dtok), jk, jv, _j(dt), _j(dc), _j(ds), _j(wb), _j(ws),
        _j(pos), attn_impl="jnp")
    tl2 = M.paged_decode_step(cfg, tp, _t(dtok).long(), [tk], [tv], _t(dt),
                              _t(dc), _t(ds), _t(wb), _t(ws), _t(pos))
    assert tl2.shape == (B, 1, cfg.vocab_size)
    assert np.max(np.abs(tl2.numpy() - np.asarray(jl2))) <= eps
    _pool_close(tk, jk2, dtype, 1e-5)
    _pool_close(tv, jv2, dtype, 1e-5)


def test_init_params_is_seeded_and_shaped():
    cfg = get_reduced("qwen2-0.5b")
    a, b = M.init_params(cfg, 3), M.init_params(cfg, 3)
    jp = JM.init_params(jax_reduced("qwen2-0.5b"), jax.random.PRNGKey(3))
    for key in ("embed", "final_norm"):
        assert torch.equal(a[key], b[key])
        assert tuple(a[key].shape) == jp[key].shape
    for key, w in a["blocks"].items():
        assert tuple(w.shape) == jp["blocks"][key].shape, key
        assert w.dtype == torch.bfloat16
