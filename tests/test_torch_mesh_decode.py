"""The decode cache in the reference's layout on a ``(data, model)`` mesh
of CPU shards (``launch/sharding.py::cache_layout``), against JAX.

KV heads that do not split over the model axis lie hd over model (the
shards' partial scores added on the controller); a batch the data axes do
not divide splits the cache's sequence over them (distributed-context
decode: each replica attends to its slice and replica 0 merges the
partials).  ``model.replica_prefill`` (into that layout, with room for
the decode) and three ``replica_decode_step`` calls against
``repro.models.model.prefill`` and ``decode_step`` over the prefill's
cache copied into a longer one, as the reference's sequential engine
does: the logits of each within ``LOGIT_RTOL`` x max |logit| in f32 at
reduced size.  Also: a slice with no visible key (finite, within the
same tolerance), whole KV heads keeping the port's layout, and the
cache's K/V and recurrent state bytes on the busiest card of the
production mesh.
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
from repro_torch.configs import ASSIGNED, get_config, get_reduced
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M

LOGIT_RTOL = 1e-5
STEPS = 3


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


_SETUP = {}


def _setup(arch):
    if arch not in _SETUP:
        jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
        _SETUP[arch] = (jcfg, jp, cfg, M.params_from_numpy(_flat(jp), cfg))
    return _SETUP[arch]


def _tokens(cfg, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (1, S + STEPS), dtype=np.int32)


_REF = {}


def _reference(arch, S, max_len):
    """The reference's prefill of S tokens, then STEPS decode steps over
    its cache copied into one of ``max_len`` positions: the logits of
    each."""
    key = (arch, S, max_len)
    if key not in _REF:
        jcfg, jp, cfg, _ = _setup(arch)
        toks = _tokens(cfg, S, seed=S)
        jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])})
        dc = JM.init_decode_cache(jcfg, 1, max_len)
        for n in ("k", "v"):
            dc[n] = dc[n].at[:, :, :S].set(jc[n])
        if "ssm" in jc:
            dc["ssm"] = jc["ssm"]
        out = [np.asarray(jl)]
        for i in range(STEPS):
            pos = jnp.asarray([S + 1 + i], jnp.int32)
            lg, dc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, S + i:S + i + 1]),
                                    dc, pos)
            out.append(np.asarray(lg))
        _REF[key] = (toks, out)
    return _REF[key]


def _placed(cfg, params, mesh):
    return M.with_slices(sh.place_train(params, cfg, mesh), 0,
                         sh.train_dims(cfg, mesh))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


CASES = [
    # (arch, mesh, prefill tokens, cache positions, the layout's model split)
    ("qwen2-0.5b", (1, 4), 21, 24, "hd"),
    ("qwen2-0.5b", (2, 1), 21, 24, "none"),
    ("qwen2-0.5b", (2, 4), 21, 24, "hd"),
    # windows of 64: at positions 101-103 every slice of (2, 4) holds a
    # visible key; on (4, 2) slice 0 (positions 0-31) holds none, so the
    # merge starts from an empty slice, over whole KV heads
    ("gemma3-12b", (2, 4), 100, 128, "hd"),
    ("gemma3-12b", (4, 2), 100, 128, "heads"),
    ("gemma2-27b", (2, 4), 21, 24, "hd"),
    ("hymba-1.5b", (2, 4), 21, 24, "hd"),
]


@pytest.mark.parametrize("arch,shape,S,max_len,model", CASES,
                         ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}" for c in CASES])
def test_prefill_then_decode_match_jax(arch, shape, S, max_len, model):
    _, _, cfg, params = _setup(arch)
    toks, want = _reference(arch, S, max_len)
    mesh = make_debug_mesh(*shape, device="cpu")
    lay = sh.cache_layout(cfg, mesh, 1, max_len)
    assert lay == sh.CacheLayout(1, shape[0], model)
    tree = _placed(cfg, params, mesh)
    with torch.no_grad():
        logits, cache = M.replica_prefill(
            cfg, tree, {"tokens": torch.as_tensor(toks[:, :S])}, mesh=mesh,
            max_len=max_len)
        _close(logits, want[0])
        k = cache["k"]
        assert isinstance(k, M.SeqSlices) == (shape[0] > 1)
        for i in range(STEPS):
            got = M.replica_decode_step(
                cfg, tree, torch.as_tensor(toks[:, S + i:S + i + 1]), cache,
                torch.tensor([S + 1 + i], dtype=torch.int32), mesh=mesh)
            _close(got, want[i + 1])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b"])
def test_a_slice_with_no_visible_key(arch):
    """Decode steps from position 1 over a fresh (2, 4) cache of 32
    positions: replica 1's slice (16-31) holds no visible key, so its
    partial weighs exactly 0; the logits are finite and the reference's."""
    jcfg, jp, cfg, params = _setup(arch)
    toks = _tokens(cfg, 0, seed=11)
    mesh = make_debug_mesh(2, 4, device="cpu")
    tree = _placed(cfg, params, mesh)
    cache = M.replica_decode_cache(cfg, 1, 32, params=tree, mesh=mesh)
    assert isinstance(cache["k"], M.SeqSlices)
    jc = JM.init_decode_cache(jcfg, 1, 32)
    for i in range(STEPS):
        pos = np.asarray([1 + i], np.int32)
        want, jc = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]), jc,
                                  jnp.asarray(pos))
        with torch.no_grad():
            got = M.replica_decode_step(cfg, tree,
                                        torch.as_tensor(toks[:, i:i + 1]),
                                        cache, torch.as_tensor(pos),
                                        mesh=mesh)
        _close(got, np.asarray(want))


def _layout(kv):
    return [(tuple(t.shape), t.device) for t in M._parts(kv)]


def test_whole_kv_heads_keep_their_layout():
    """Where the KV heads split whole over model the cache lies by whole
    heads, as a replica's ServingMesh lays it out: the same shapes on the
    same devices; a divisible batch gives each replica its rows.  A
    ServingMesh keeps the paged pool's rule: heads that do not split lie
    whole on the controller."""
    _, _, cfg, params = _setup("qwen2-0.5b")
    mesh = make_debug_mesh(1, 2, device="cpu")
    tree = _placed(cfg, params, mesh)
    old = M.replica_decode_cache(cfg, 2, 8, params=tree, mesh=mesh.replica(0))
    new = M.replica_decode_cache(cfg, 2, 8, params=tree, mesh=mesh)
    for n in ("k", "v"):
        assert _layout(new[n]) == _layout(old[n]) == \
            [((cfg.n_layers, 2, 8, 1, cfg.hd), torch.device("cpu"))] * 2
    two = make_debug_mesh(2, 2, device="cpu")
    assert sh.cache_layout(cfg, two, 4, 8) == sh.CacheLayout(2, 1, "heads")
    four = make_debug_mesh(1, 4, device="cpu")
    assert sh.cache_layout(cfg, four.replica(0), 2, 8) == \
        sh.CacheLayout(2, 1, "none")
    assert sh.cache_layout(cfg, four, 2, 8) == sh.CacheLayout(2, 1, "hd")


def _expected_kv(cfg, info, mesh) -> int:
    """2 L B S KV hd x 2 B over the splits the reference's
    ``cache_shardings`` applies (the data axes on the batch or the
    sequence, model on hd; whole heads hold the same bytes)."""
    total = 2 * cfg.n_layers * info["batch"] * info["seq"] * \
        cfg.n_kv_heads * cfg.hd * 2
    cache = M.init_decode_cache(cfg, info["batch"], info["seq"],
                                device="meta")
    spec = sh.cache_shardings(cfg, {"k": cache["k"]}, mesh, info["batch"])
    n = 16 if any(a not in (None, "model") for a in spec["k"]) else 1
    return total // n // (16 if "model" in spec["k"] else 1)


# the busiest card's K/V bytes in GB, as the reference lays them out
REFERENCE_GB = {("gemma3-12b", "decode_32k"): 6.4,
                ("gemma3-12b", "long_500k"): 0.81,
                ("llama2-70b", "decode_32k"): 5.4,
                ("yi-34b", "decode_32k"): 4.0,
                ("mixtral-8x7b", "long_500k"): 0.27,
                ("gemma2-27b", "long_500k"): 0.77}


def _expected_state(cfg, info, mesh) -> int:
    """The recurrent state's bytes on replica 0's controller: each leaf's
    over the splits ``cache_shardings`` applies (the data axes on the
    batch, model on hd or the largest dim of at least 4 x model); 0 for
    the attention-only families."""
    cache = M.init_decode_cache(cfg, info["batch"], 0, device="meta")
    if cfg.family == "hybrid":
        cache = {"ssm": cache["ssm"]}
    elif cfg.family != "ssm":
        return 0
    total = 0
    for group in cache.values():
        for i, leaf in enumerate(group if isinstance(group, tuple)
                                 else [group] if group is not None else []):
            key = "ssm" if cfg.family == "hybrid" else str(i)
            spec = sh.cache_shardings(cfg, {key: leaf}, mesh,
                                      info["batch"])[key]
            n = 16 if any(a not in (None, "model") for a in spec) else 1
            total += leaf.nbytes // n // (16 if "model" in spec else 1)
    return total


def test_cache_bytes_on_the_busiest_card_of_the_production_mesh():
    """Every applicable decode shape of every assigned arch (and
    LLaMA2-70B) on the (16, 16) mesh of fake cards: the cache's K/V bytes
    and its recurrent state's on the busiest card of replica 0 equal the
    whole cache's over the splits that apply."""
    mesh = dryrun.fake_mesh(16, 16)
    seen = set()
    for arch in list(ASSIGNED) + ["llama2-70b"]:
        cfg = get_config(arch)
        for shape in ("decode_32k", "long_500k"):
            if not specs.shape_applicable(cfg, shape)[0]:
                continue
            fig = dryrun.cache_figures(cfg, shape, mesh)
            info = specs.SHAPES[shape]
            want = 0 if cfg.family == "ssm" else _expected_kv(cfg, info, mesh)
            assert fig["kv_cache_bytes"] == want, (arch, shape, fig, want)
            state = _expected_state(cfg, info, mesh)
            assert fig["state_bytes"] == state, (arch, shape, fig, state)
            assert (state > 0) == (cfg.family in ("ssm", "hybrid"))
            if (arch, shape) in REFERENCE_GB:
                gb = REFERENCE_GB[(arch, shape)]
                assert round(want / 1e9, 2 if gb < 1 else 1) == gb
                seen.add((arch, shape))
    assert seen == set(REFERENCE_GB)
