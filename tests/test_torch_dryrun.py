"""The compile analysis as a dry run on fake cards (``launch/specs.py``,
``launch/op_analysis.py``, ``launch/dryrun.py``, ``launch/perf_probe.py``)
against the JAX package's ``specs``/``hlo_analysis``/``dryrun``.

Against the reference: ``SHAPES``, ``supports_long_context`` and
``shape_applicable``; every argument's global shape, dtype and spec for
the reference test's 4 archs x 4 shapes, shrunk as
``tests/test_sharding.py`` shrinks them, on a (2, 4) mesh (the
reference's side runs ``eval_shape`` and the shardings only, no compile,
in a subprocess with 8 forced host devices); ``model_flops`` and the
params' bytes; the FLOPs of one product and of loops of products against
``hlo_analysis.analyze`` of the jitted product and ``lax.scan``.

Within the port: the dry run of those 15 cases on a (2, 4) mesh of fake
cards; the fake run's FLOPs and kernel calls against the same step run on
real CPU tensors (whose shards share the one CPU device, so no copy
crosses a card there); the CLI and the probe.
``tests/test_torch_dryrun_whole.py`` holds the production meshes'
coverage (replica 0 traced, the others standing in) to the whole mesh
traced.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ASSIGNED, get_config, get_reduced
from repro_torch.launch import dryrun, op_analysis, perf_probe, specs
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "train_4k": dict(kind="train", seq=64, batch=8),
    "prefill_32k": dict(kind="prefill", seq=128, batch=8),
    "decode_32k": dict(kind="decode", seq=128, batch=8),
    "long_500k": dict(kind="decode", seq=256, batch=1),
}
ARCHS = ["qwen2-0.5b", "mixtral-8x7b", "xlstm-1.3b", "hymba-1.5b"]

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.configs import get_reduced
    from repro.launch import specs as SP
    SP.SHAPES = %r
    mesh = jax.make_mesh((2, 4), ("data", "model"))

    def key(k):
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                return str(getattr(k, a))
        return str(k)

    def spec(s, nd):
        out = [list(e) if isinstance(e, tuple) else e for e in s.spec]
        return out + [None] * (nd - len(out))

    out = {}
    for arch in %r:
        cfg = get_reduced(arch)
        for shape in SP.SHAPES:
            ok, _ = SP.shape_applicable(cfg, shape)
            if not ok:
                continue
            with mesh:
                fn, args, donate, out_sh = SP.input_specs(cfg, shape, mesh)
            leaves = []
            for i, a in enumerate(args):
                for path, l in jax.tree_util.tree_flatten_with_path(a)[0]:
                    leaves.append([i, [key(k) for k in path], list(l.shape),
                                   str(l.dtype), spec(l.sharding, l.ndim)])
            out[arch + "/" + shape] = leaves
    print("RESULT" + json.dumps(out))
""")


def _dtype(dt) -> str:
    return str(dt).split(".")[-1]


def _spec(s, nd):
    out = [list(e) if isinstance(e, tuple) else e for e in s]
    return out + [None] * (nd - len(out))


def _port_leaves(cfg, shape, mesh):
    """The port's global specs as the reference script lists its args'."""
    g = specs.global_specs(cfg, SMALL[shape], mesh)
    kind = SMALL[shape]["kind"]
    rows = []

    def add(i, path, entry):
        sh, dt, sp = entry
        rows.append([i, list(path), list(sh), _dtype(dt), _spec(sp, len(sh))])

    for path, e in g["params"].items():
        add(0, path, e)
    if kind == "train":
        for w in ("m", "v"):
            for path, e in g["opt"][w].items():
                add(1, (w,) + path, e)
        for name, e in g["batch"].items():
            add(2, (name,), e)
    elif kind == "prefill":
        for name, e in g["batch"].items():
            add(1, (name,), e)
    else:
        add(1, (), g["tokens"])
        for path, e in g["cache"].items():
            add(2, path, e)
        add(3, (), g["pos"])
    return rows


@pytest.fixture(scope="module")
def reference_args():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT % (SMALL, ARCHS)],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


def test_shapes_and_applicability_match_the_reference():
    from repro.configs import get_config as jget
    from repro.launch import specs as JS
    assert specs.SHAPES == JS.SHAPES
    for arch in ASSIGNED:
        cfg, jcfg = get_config(arch), jget(arch)
        assert specs.supports_long_context(cfg) == \
            JS.supports_long_context(jcfg), arch
        for shape in specs.SHAPES:
            assert specs.shape_applicable(cfg, shape) == \
                JS.shape_applicable(jcfg, shape), (arch, shape)
    expected = {
        "xlstm-1.3b": True, "hymba-1.5b": True, "gemma3-12b": True,
        "gemma2-27b": True, "mixtral-8x7b": True,
        "yi-34b": False, "phi3.5-moe-42b-a6.6b": False,
        "internvl2-1b": False, "musicgen-large": False, "qwen2-0.5b": False,
    }
    for arch, want in expected.items():
        assert specs.supports_long_context(get_config(arch)) == want, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, reference_args):
    """Every argument's global shape, dtype and spec (the optimizer's step
    counter aside: the port keeps it on replica 0's controller), and the
    port's placed args hold the shards those specs give."""
    mesh = dryrun.fake_mesh(2, 4, whole=True)
    cfg = get_reduced(arch)
    for shape in SMALL:
        ok, _ = specs.shape_applicable(cfg, shape)
        key = f"{arch}/{shape}"
        assert ok == (key in reference_args), key
        if not ok:
            continue
        ref = [r for r in reference_args[key] if r[1] != ["step"]]
        got = _port_leaves(cfg, shape, mesh)
        norm = [[r[0], [str(k) for k in r[1]], r[2], r[3], r[4]]
                for r in got]
        assert sorted(map(json.dumps, norm)) == \
            sorted(map(json.dumps, ref)), key
        with FakeTensorMode():
            _, args, _, _ = specs.input_specs(cfg, SMALL[shape], mesh)
            placed = args[0]
            tree = placed[0] if isinstance(placed, list) else placed
            g = specs.global_specs(cfg, SMALL[shape], mesh)["params"]
            for path, leaf in SH._leaves(tree):
                shp, _, sp = g[path]
                parts = leaf if isinstance(leaf, tuple) else (leaf,)
                want = [n // (4 if a == "model" and len(parts) > 1 else 1)
                        for n, a in zip(shp, _spec(sp, len(shp)))]
                assert all(list(p.shape) == want for p in parts), (key, path)


def test_model_flops_and_param_bytes_match_the_reference():
    import jax
    from repro.configs import get_config as jget
    from repro.models import model as JM
    for arch in ASSIGNED:
        cfg, jcfg = get_config(arch), jget(arch)
        assert cfg.n_active_params() == jcfg.n_active_params(), arch
        tree = M.init_params(cfg, 0, device="meta")
        port = sum(l.numel() * l.element_size() for _, l in SH._leaves(tree))
        ref = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
        want = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                   for l in jax.tree_util.tree_leaves(ref))
        assert port == want, arch
        info = specs.SHAPES["train_4k"]
        got = dryrun.roofline(op_analysis.Tally(), dryrun.fake_mesh(2, 2),
                              cfg, "train_4k")["model_flops"]
        assert got == 6.0 * jcfg.n_active_params() * info["batch"] \
            * info["seq"], arch


def test_op_analysis_counts_products_as_hlo_analysis():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from repro.launch.hlo_analysis import analyze as hlo

    def compiled(fn, *shapes):
        return jax.jit(fn).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                                   for s in shapes]).compile().as_text()

    with FakeTensorMode():
        x = torch.empty(256, 128, device="meta:0")
        w = torch.empty(128, 64, device="meta:0")
        _, t = op_analysis.analyze(lambda a, b: a @ b, x, w)
    want = hlo(compiled(lambda a, b: a @ b, (256, 128), (128, 64))).flops
    assert t.cards[torch.device("meta:0")].flops == pytest.approx(want,
                                                                  rel=0.01)

    def scan(x, ws):
        return lax.scan(lambda c, w: (c @ w, None), x, ws)[0]

    def nested(x, ws):
        def outer(c, row):
            return lax.scan(lambda c2, w: (c2 @ w, None), c, row)[0], None
        return lax.scan(outer, x, ws)[0]

    for fn, xs, ws in ((scan, (128, 128), (7, 128, 128)),
                       (nested, (64, 64), (3, 5, 64, 64))):
        want = hlo(compiled(fn, xs, ws)).flops
        with FakeTensorMode():
            x = torch.empty(xs, device="meta:1")
            w = torch.empty(ws, device="meta:1")

            def loop(x, ws):
                for wi in ws.reshape(-1, *ws.shape[-2:]):
                    x = x @ wi
                return x
            _, t = op_analysis.analyze(loop, x, w)
        assert t.cards[torch.device("meta:1")].flops == \
            pytest.approx(want, rel=0.01)


def test_dry_run_of_the_reference_cases_on_a_small_mesh():
    """The reference's test_dryrun_machinery_small_mesh without its
    compile: 15 cases, each with FLOPs on replica 0's cards and the prefix
    kernel counted wherever a sequence attends."""
    mesh = dryrun.fake_mesh(2, 4)
    done = 0
    for arch in ARCHS:
        cfg = get_reduced(arch)
        for shape, info in SMALL.items():
            if not specs.shape_applicable(cfg, shape)[0]:
                continue
            tally, _ = dryrun.analyze_case(cfg, info, mesh)
            cards = [tally.cards[d] for d in mesh.replica(0).devices
                     if d in tally.cards]
            assert sum(c.flops for c in cards) > 0, (arch, shape)
            calls = sum(c.kernels.get("prefix_flash_attention", 0)
                        for c in cards)
            attends = cfg.family != "ssm" and info["kind"] != "decode"
            assert (calls > 0) == attends, (arch, shape, calls)
            done += 1
    assert done == 15


@pytest.mark.parametrize("arch,opts", [
    ("qwen2-0.5b", ()), ("mixtral-8x7b", ("moe-capacity",)),
    ("hymba-1.5b", ()), ("xlstm-1.3b", ()),
    ("qwen2-0.5b", ("seq-par", "flat-gqa"))])
def test_fake_tally_equals_the_real_tally(arch, opts):
    """One train step and one prefill of a (2, 2) mesh on fake cards and
    on real CPU tensors: the same FLOPs and kernel calls in all (the
    kernel's plain version paused, the scans' stand-ins on the fake
    side)."""
    cfg, lay = dryrun.apply_opts(get_reduced(arch), opts)
    for shape in ("train_4k", "prefill_32k"):
        info = dict(SMALL[shape], batch=4)
        tally, _ = dryrun.analyze_case(cfg, info, dryrun.fake_mesh(2, 2,
                                                                   whole=True),
                                       lay, computed=None)
        mesh = make_debug_mesh(2, 2, device="cpu")
        params = M.init_params(cfg, 0)
        fn, args, _, _ = specs.input_specs(cfg, info, mesh, lay,
                                           computed=None, params=params)
        _, real = op_analysis.analyze(fn, *args)
        fake = list(tally.cards.values())
        cpu = real.cards[torch.device("cpu")]
        assert sum(c.flops for c in fake) == cpu.flops, (arch, shape)
        calls = {}
        for c in fake:
            for k, n in c.kernels.items():
                calls[k] = calls.get(k, 0) + n
        assert calls == cpu.kernels, (arch, shape)


def test_dryrun_cli_and_perf_probe(tmp_path, capsys, monkeypatch):
    """One case on the production (16, 16) mesh through the CLI, at the
    reduced config: its record's keys, the H100 peaks and no TPU
    constant, the specs with the layout's notes; the probe prints its
    figures."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    monkeypatch.setattr(perf_probe, "get_config", get_reduced)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "qwen2-0.5b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    rl = rec["roofline"]
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
              "model_flops", "useful_ratio", "collectives"):
        assert k in rl, k
    assert rl["peaks"]["bf16_flops_per_s"] == 989e12
    text = json.dumps(rec)
    for tpu in ("197e12", "819e9", "50e9", "v5e"):
        assert tpu not in text.replace(" ", ""), tpu
    assert any("layout:" in ln for ln in rec["partition_specs"])
    assert rec["memory"]["peak_bytes"] > 0
    # skip-if-exists: a second run reads the record back
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert "[ok     ] qwen2-0.5b" in capsys.readouterr().out
    perf_probe.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--top", "3"])
    out = capsys.readouterr().out
    assert "flops/card=" in out and "top transfers" in out


@pytest.mark.parametrize("sq,prefix,window", [(1100, 0, 0), (1024, 300, 256),
                                              (600, 0, 0)])
def test_flash_backward_stand_in_counts_the_loops_products(sq, prefix,
                                                           window):
    """On fake tensors ``layers.flash_attention_bwd`` runs one tile of each
    pass and counts the others' products: the FLOPs and product bytes of
    the whole loop run on real tensors."""
    from repro_torch.models import layers as L
    B, H, KV, hd = 1, 4, 2, 16
    shapes = [(B, sq, H, hd), (B, prefix + sq, KV, hd),
              (B, prefix + sq, KV, hd), (B, sq, H, hd), (B, sq, H, hd)]

    def run(ts):
        return op_analysis.analyze(lambda *a: L.flash_attention_bwd(
            *a, q_offset=prefix, window=window), *ts)[1]

    real = run([torch.randn(s) for s in shapes]).cards[torch.device("cpu")]
    with FakeTensorMode():
        fake = run([torch.empty(s, device="meta:0") for s in shapes])
    f = fake.cards[torch.device("meta:0")]
    assert (f.flops, f.dot_bytes) == (real.flops, real.dot_bytes)
