"""Compile analysis as a dry run on fake H100 cards (counterpart of
``repro.launch.dryrun``): every (architecture x input shape) of the
production mesh, its per-card work, transfers and memory, and a
three-term roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape prefill_32k --opt seq-par
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results are JSON files under ``experiments/dryrun_torch/`` (skip if it
exists, so the sweep is resumable; ``--force`` redoes a case).  The exit
code is 1 when any record is an error.

How it runs.  The reference lowers and compiles the program and reads XLA's
HLO.  The port runs its own step (``launch/specs.py::input_specs``) on
fake tensors (``FakeTensorMode``: shapes and dtypes, no memory, no
values) under ``launch/op_analysis.py``'s tally, so every product, kernel
call, copy between cards and live storage is counted as the step makes
it.  The cards are fake tensors on ``meta:i``: a CPU build of torch
aborts when autograd records a fake CUDA tensor (its input metadata asks
CUDA for a stream), and the analysis needs only distinct devices.

How the production meshes are covered.  torch keeps a device index in 8
bits, so 256 (512) cards cannot each have one.  The dry run traces data
replica 0 on cards ``0 .. 15``; every other replica stands on one peer
card a model index (``16 + m``), holds its own placed params and
moments there, and its grads stand in as tensors of replica 0's shapes
(``computed=1``; data replicas do the same work on their own rows).  The
update (``optimizer.apply_updates_zero``) then runs over every replica,
so replica 0's cards see the whole mesh's ZeRO-1 transfers and memory.
``tests/test_torch_dryrun_whole.py`` holds this to the whole mesh traced
on a (4, 8) fake mesh.  Prefill runs replica 0's step (replicas exchange
nothing there).  Decode runs over the whole mesh, its cache laid out by
``launch/sharding.py::cache_layout``: a batch the data axes divide is
replica 0's rows (replicas exchange nothing); otherwise the sequence
splits over the replicas, the other replicas' slices lie on the peer
cards, replica 0 sends them the step's q, k and v pieces, and their
partial attention stands in (``computed=1``) before replica 0 merges it;
``tests/test_torch_dryrun_decode.py`` holds that to the whole (4, 8)
mesh too.  Figures are per card, of replica 0's cards: the busiest in
each term, and the controller beside shard 1.  A decode record's
``memory`` adds the cache's bytes on the busiest of those cards
(``cache_figures``).

Records keep the reference's keys where the port has the quantity
(``memory``, ``roofline`` with ``t_compute_s``, ``t_memory_s``,
``t_collective_s``, ``dominant``, ``model_flops``, ``useful_ratio``,
``collectives``; ``partition_specs``).  ``raw_cost_analysis_flops`` and
``lower_s``/``compile_s`` have no meaning here and are dropped; ``run_s``
is the dry run's wall time on this host.  The roofline takes the
published peaks of an NVIDIA H100 SXM (``PEAK_FLOPS``, ``HBM_BW``,
``LINK_BW``; not measurements): compute = the card's FLOPs over the bf16
dense peak, memory = its product bytes over the memory rate, collective
= the larger of the bytes into and out of it over NVLink's rate each
way.  A model axis of 16 spans two 8-card hosts, so that link term is a
lower bound (the record says so).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch import op_analysis
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import model as M

# NVIDIA H100 SXM, published peaks (not measured here)
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # device memory bytes/s
LINK_BW = 450e9            # NVLink bytes/s each way
CARD = "NVIDIA H100 SXM"
HOST_CARDS = 8             # cards a host's NVLink joins
OPTS = ("moe-capacity", "attn-fallback", "seq-par", "flat-gqa")


def options(opts) -> SH.Options:
    """The layout options of ``--opt`` flags (``moe-capacity`` is a config
    change: ``apply_opts``)."""
    unknown = set(opts) - set(OPTS)
    if unknown:
        raise ValueError(f"unknown --opt {sorted(unknown)}; the options are "
                         f"{list(OPTS)}")
    return SH.Options(seq_par="seq-par" in opts,
                      flat_gqa="flat-gqa" in opts,
                      attn_fallback="attn-fallback" in opts)


def apply_opts(cfg, opts):
    """(config, layout options) of ``--opt`` flags."""
    if "moe-capacity" in opts:
        cfg = dataclasses.replace(cfg, moe_impl="capacity")
    return cfg, options(opts)


def fake_mesh(n_data: int, n_model: int, pods: int = 1,
              whole: bool = False) -> DeviceMesh:
    """A ``(n_data, n_model)`` mesh of fake cards: each card its own device
    (``whole``), or replica 0 on cards ``0 .. n_model-1`` and every other
    replica's shard m on the peer card ``n_model + m``."""
    def device(d, m):
        if whole or d == 0:
            return torch.device("meta", d * n_model + m)
        return torch.device("meta", n_model + m)
    if (n_data, n_model) == (16 * pods, 16):
        return make_production_mesh(multi_pod=pods > 1, device=device)
    grid = tuple(tuple(device(d, m) for m in range(n_model))
                 for d in range(n_data))
    return DeviceMesh(grid, pods=pods)


def analyze_case(cfg, shape, mesh, opts: SH.Options = SH.NO_OPTIONS,
                 computed=1):
    """Run ``shape``'s step of ``cfg`` over ``mesh`` on fake tensors under
    a tally: (the tally, the step's wall seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, args, _, _ = specs.input_specs(cfg, shape, mesh, opts,
                                           computed=computed)
        out, tally = op_analysis.analyze(fn, *args)
        del out, args
    return tally, time.perf_counter() - t0


def cache_figures(cfg, shape, mesh) -> dict:
    """The decode cache of ``shape`` on replica 0's cards as the decode
    step lays it out (``models/model.py::replica_decode_cache``): the
    busiest card's bytes of the whole cache, of its K/V and of its
    recurrent state (the rest)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_flatten
    info = specs._info(shape)
    with FakeTensorMode():
        cache = M.replica_decode_cache(cfg, info["batch"], info["seq"],
                                       mesh=mesh)
    kv = tree_flatten([cache[n] for n in ("k", "v") if n in cache])[0]
    every = tree_flatten(cache)[0]
    row = mesh.replica(0).devices

    def on(dev, ts):
        return sum(t.nbytes for t in ts if t.device == dev)
    card = max(row, key=lambda d: (on(d, every), -row.index(d)))
    return {"cache_card": str(card), "cache_bytes": on(card, every),
            "kv_cache_bytes": on(card, kv),
            "state_bytes": on(card, every) - on(card, kv)}


def _n_tokens(info) -> int:
    return info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)


def roofline(tally, mesh, cfg, shape) -> dict:
    """The three-term roofline of replica 0's cards: each term the
    slowest card's, from the published peaks; ``model_flops`` as the
    reference counts them (6 or 2 x active params x tokens) over every
    computing card's FLOPs (replica 0's times the replicas that share
    the batch)."""
    info = specs._info(shape)
    row = mesh.replica(0).devices
    cards = {d: tally.cards.get(d, op_analysis.Totals()) for d in row}
    t_c = {d: t.flops / PEAK_FLOPS for d, t in cards.items()}
    t_m = {d: t.dot_bytes / HBM_BW for d, t in cards.items()}
    t_x = {d: max(t.bytes_in, t.bytes_out) / LINK_BW
           for d, t in cards.items()}
    worst = {name: max(ts, key=ts.get) for name, ts in
             (("compute", t_c), ("memory", t_m), ("collective", t_x))}
    terms = {"compute": t_c[worst["compute"]],
             "memory": t_m[worst["memory"]],
             "collective": t_x[worst["collective"]]}
    dominant = max(terms, key=terms.get)
    bax, n = SH.batch_spec(cfg, info["batch"], mesh)
    replicas = n if bax is not None else 1
    total = replicas * sum(t.flops for t in cards.values())
    mult = 6.0 if info["kind"] == "train" else 2.0
    model_flops = mult * cfg.n_active_params() * _n_tokens(info)
    busiest = cards[worst["compute"]]
    coll = {k: 0.0 for k in op_analysis.COLLECTIVES}
    coll_count = 0.0
    for t in cards.values():
        for k, v in t.coll.items():
            coll[k] = max(coll[k], v)
        coll_count = max(coll_count, t.coll_count)
    return {
        "flops_per_card": busiest.flops,
        "dot_bytes_per_card": cards[worst["memory"]].dot_bytes,
        "collective_bytes_per_card": max(max(t.bytes_in, t.bytes_out)
                                         for t in cards.values()),
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": dominant,
        "card_of_term": {k: str(v) for k, v in worst.items()},
        "model_flops": model_flops,
        "useful_ratio": model_flops / total if total else 0.0,
        "collectives": dict(coll, count=coll_count),
        "peaks": {"card": CARD, "bf16_flops_per_s": PEAK_FLOPS,
                  "memory_bytes_per_s": HBM_BW,
                  "nvlink_bytes_per_s_each_way": LINK_BW,
                  "source": "published peaks, not measured"},
        "link_note": (f"the model axis of {mesh.shape['model']} spans "
                      f"{-(-mesh.shape['model'] // HOST_CARDS)} hosts of "
                      f"{HOST_CARDS} NVLink cards: t_collective is a lower "
                      f"bound" if mesh.shape["model"] > HOST_CARDS else
                      "the model axis fits one NVLink host"),
    }


def _card_figures(tally, dev) -> dict:
    return tally.cards.get(dev, op_analysis.Totals()).figures()


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
            force: bool = False, opts=()) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = ("__" + "+".join(sorted(opts))) if opts else ""
    out_file = out_dir / f"{arch}__{shape_name}__{mesh_name}{tag}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "opts": sorted(opts)}
    try:
        cfg, lay = apply_opts(get_config(arch), opts)
        ok, reason = specs.shape_applicable(cfg, shape_name)
        if not ok:
            rec.update(status="skipped", reason=reason)
            out_file.write_text(json.dumps(rec, indent=2))
            return rec
        pods = 2 if multi_pod else 1
        mesh = fake_mesh(16 * pods, 16, pods)
        tree = M.init_params(cfg, 0, device="meta")
        spec_text = SH.spec_summary(cfg, mesh, tree, lay.attn_fallback)
        notes = SH.layout_notes(cfg, mesh, lay)
        print(spec_text, flush=True)
        rec["partition_specs"] = spec_text.splitlines() + [
            f"  layout: {n}" for n in notes]
        tally, wall = analyze_case(cfg, shape_name, mesh, lay)
        row = mesh.replica(0).devices
        peak_dev = max(row, key=lambda d: _card_figures(tally, d)
                       ["peak_bytes"])
        mem = _card_figures(tally, peak_dev)
        if specs._info(shape_name)["kind"] == "decode":
            mem.update(cache_figures(cfg, shape_name, mesh))
        rec.update(
            status="ok",
            n_chips=mesh.n_replicas * mesh.shape["model"],
            mesh_shape=mesh.shape,
            run_s=round(wall, 1),
            memory={"card": str(peak_dev),
                    "argument_bytes": mem["argument_bytes"],
                    "output_bytes": mem["output_bytes"],
                    "temp_bytes": mem["peak_bytes"] - mem["argument_bytes"],
                    "peak_bytes": mem["peak_bytes"],
                    **{k: mem[k] for k in ("cache_card", "cache_bytes",
                                           "kv_cache_bytes", "state_bytes")
                       if k in mem}},
            roofline=roofline(tally, mesh, cfg, shape_name),
            controller=_card_figures(tally, row[0]),
            shard=_card_figures(tally, row[1 % len(row)]),
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    out_file.write_text(json.dumps(rec, indent=2))
    return rec


def _gb(x):
    return f"{x / 2**30:.2f}GiB" if isinstance(x, (int, float)) and x else "?"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(specs.SHAPES)
                    + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="append", default=[], choices=OPTS)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(specs.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multi"]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape, mp, out_dir, force=args.force,
                              opts=tuple(args.opt))
                status = rec["status"]
                if status == "ok":
                    rl, mem = rec["roofline"], rec["memory"]
                    kv = (f"cache={_gb(mem['cache_bytes'])} "
                          if "cache_bytes" in mem else "")
                    extra = (f"dom={rl['dominant']} "
                             f"tc={rl['t_compute_s']:.3e} "
                             f"tm={rl['t_memory_s']:.3e} "
                             f"tx={rl['t_collective_s']:.3e} "
                             f"peak={_gb(mem['peak_bytes'])} {kv}"
                             f"({rec['run_s']}s)")
                elif status == "error":
                    failures += 1
                    extra = rec["error"][:120]
                else:
                    extra = rec.get("reason", "")[:60]
                print(f"[{status:7s}] {arch:24s} {shape:12s} "
                      f"{'multi' if mp else 'single':6s} {extra}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
