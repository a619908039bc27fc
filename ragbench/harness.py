"""One run of one cell: set-up, warm-up, the paced window, the check.

``run_cell`` is what ``run.py`` calls on the card.  The tests call it on the
CPU at reduced sizes (``device="cpu"``); only ``run.py`` looks for a card.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ragbench import check, record, traffic as traffic_mod, weights
from ragbench.instrument import TimedIndex, Tracer
from ragbench.paced import PacedRuntime

BENCH = Path(__file__).resolve().parent

# config file key -> the port's ModelConfig field it must equal
PUBLISHED = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
             "sliding_window": "sliding_window",
             "num_local_experts": "moe_experts",
             "num_experts_per_tok": "moe_top_k"}


def load(kind: str, name: str) -> Dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def port_config(c: Dict):
    """The program's ModelConfig for a configuration file: the port's
    registered config with the file's replacements, held to every published
    size the file gives."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(c["port"]["config"]),
                              **c["port"]["replace"])
    if cfg.sliding_window and cfg.global_every:
        raise ValueError(f"{cfg.name}: global layers are not modelled")
    for key, field in PUBLISHED.items():
        if key in c and (c[key] or 0) != getattr(cfg, field):
            raise ValueError(f"{c['name']}: {key} {c[key]} but the port's "
                             f"{field} is {getattr(cfg, field)}")
    if c.get("head_dim", cfg.hd) != cfg.hd:
        raise ValueError(f"{c['name']}: head_dim {c['head_dim']}")
    return cfg


def host_available() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def warm_shapes(torch, cfg, params, eng: Dict, max_prompt: int, device):
    """Run a prefill step of ``max_prefill_bs`` rows at every length bucket
    the runtime pads to (powers of two, 8 up to the longest prompt's) and
    the decode step, on a scratch pool: the kernels and GEMMs meet their
    shapes here, and the caching allocator holds the largest step's
    activations before the pool takes the rest of the card."""
    from repro_torch.kvcache.paged import PagedKVStore
    from repro_torch.models import model as M
    bs = eng["block_size"]
    B = eng["max_prefill_bs"]
    top = max(8, 1 << (max_prompt - 1).bit_length())
    per = -(-top // bs)
    store = PagedKVStore(cfg.n_layers, B * per + 1, bs, cfg.n_kv_heads,
                         cfg.hd, dtype=cfg.tdtype, device=device)
    blocks = torch.arange(1, B * per + 1, dtype=torch.int32,
                          device=device).view(B, per)
    starts = (torch.arange(per, dtype=torch.int32, device=device)
              * bs).expand(B, per).contiguous()
    zeros = torch.zeros((B,), dtype=torch.int32, device=device)
    for Sq in (8 << i for i in range(top.bit_length() - 3)):
        pos = torch.arange(Sq, dtype=torch.int32, device=device)
        wblk = blocks.repeat_interleave(bs, dim=1)[:, :Sq].contiguous()
        wslot = (pos % bs).expand(B, Sq).contiguous()
        counts = (Sq - starts).clamp(0, bs).to(torch.int32)
        q_len = torch.full((B,), Sq, dtype=torch.int32, device=device)
        toks = torch.zeros((B, Sq), dtype=torch.int32, device=device)
        M.paged_prefill_step(cfg, params, toks, store.k_planes,
                             store.v_planes, blocks, counts, starts, zeros,
                             q_len, wblk, wslot)
    D = eng["max_batch"]
    tb = torch.zeros((D, per), dtype=torch.int32, device=device)
    tb[:, 0] = 1
    cn = torch.zeros((D, per), dtype=torch.int32, device=device)
    cn[:, 0] = 1
    M.paged_decode_step(cfg, params, torch.zeros((D, 1), dtype=torch.int32,
                                                 device=device),
                        store.k_planes, store.v_planes, tb, cn,
                        torch.zeros_like(tb),
                        torch.ones((D,), dtype=torch.int32, device=device),
                        torch.zeros((D,), dtype=torch.int32, device=device),
                        torch.ones((D,), dtype=torch.int32, device=device))
    torch.cuda.synchronize(device)
    del store


def readers() -> Dict[str, object]:
    """Every metric reader under metrics/, by its metric's name."""
    out = {}
    for p in sorted((BENCH / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"ragbench_metric_{p.stem}", p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[p.stem] = mod
    return out


@dataclasses.dataclass
class Result:
    run: record.Run
    checks: Dict[str, Dict]
    control: Optional[Dict]
    memory_peak: int
    n_blocks: int
    n_warmup: int
    extra: Dict


def run_cell(cell: Dict, config: Dict, traffic: Dict, *, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, rate: Optional[float] = None,
             control: bool = False, clock=time.perf_counter,
             sleep=time.sleep) -> Result:
    import torch
    from repro_torch.retrieval.vectordb import IVFIndex
    from repro_torch.serving.config import EngineConfig

    t_start = clock() if t_start is None else t_start
    dev = torch.device(device)
    cfg = port_config(config)
    eng = config["engine"]
    t = traffic
    marks = [("start", clock())]
    params = weights.draw(cfg, traffic_mod.sub_seed(seed, "weights"), dev)
    marks.append(("weights", clock()))
    tr = traffic_mod.build(t, seed, seconds, rate or cell["rate"],
                           cfg.vocab_size, cell["warmup_max"])
    corpus = tr.corpus
    marks.append(("traffic", clock()))
    index = TimedIndex(IVFIndex(corpus.doc_vectors,
                                n_clusters=t["ivf_clusters"],
                                nprobe=t["nprobe"], seed=t["base_seed"]))
    marks.append(("index", clock()))
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd \
        * cfg.tdtype.itemsize
    block_bytes = eng["block_size"] * kv_bytes
    max_prompt = t["top_k"] * int(max(corpus.doc_lengths)) \
        + t["question_tokens"]
    if dev.type == "cuda":
        warm_shapes(torch, cfg, params, eng, max_prompt, dev)
        free, _ = torch.cuda.mem_get_info(dev)
        n_blocks = int((free - eng["pool_margin_bytes"]) // block_bytes)
        n_blocks -= n_blocks % 256
        avail = host_available()
        if avail is not None and eng["host_cache_bytes"] > avail // 2:
            raise RuntimeError(
                f"host tier {eng['host_cache_bytes']} B is more than half "
                f"of the {avail} B of host memory available")
    else:
        n_blocks = eng["n_blocks"]
    gpu_bytes = (n_blocks - eng["reserve_blocks"]) * block_bytes
    ec = EngineConfig(
        gpu_cache_bytes=gpu_bytes, host_cache_bytes=eng["host_cache_bytes"],
        disk_cache_bytes=0, policy=eng["policy"], top_k=t["top_k"],
        reorder=eng["reorder"], speculative=eng["speculative"],
        max_batch=eng["max_batch"], max_prefill_bs=eng["max_prefill_bs"],
        prefill_chunk=eng["prefill_chunk"],
        max_prefill_tokens=eng["max_prefill_tokens"],
        block_size=eng["block_size"])
    rt = PacedRuntime(cfg, params, corpus, index, config=ec,
                      n_blocks=n_blocks, device=dev, clock=clock,
                      sleep=sleep)
    max_new = t["max_new_tokens"]
    marks.append(("pool", clock()))
    # ---- warm-up: unpaced, until the GPU tier first evicts --------------
    n_warm, wb = 0, cell["warmup_batch"]
    while n_warm < len(tr.warmup):
        batch = tr.warmup[n_warm:n_warm + wb]
        rt.serve([dataclasses.replace(r, arrival=rt.now) for r in batch],
                 max_new_tokens=max_new)
        n_warm += len(batch)
        if rt.tree.stats["gpu_evictions"] > 0:
            break
    evicted = rt.tree.stats["gpu_evictions"] > 0
    # what set-up made is kept for the run: the collector need not scan it
    # again inside the window
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = clock() - t_start
    marks.append(("warm-up", clock()))
    steps = ", ".join(f"{b[0]} {b[1] - a[1]:.1f}"
                      for a, b in zip(marks, marks[1:]))
    log(f"[ragbench] set-up {setup_s:.3f} s: pool {n_blocks} blocks "
        f"({n_blocks * block_bytes} B), GPU tier {gpu_bytes} B, host tier "
        f"{eng['host_cache_bytes']} B; warm-up {n_warm} requests "
        f"({'the GPU tier evicted' if evicted else 'no eviction'}); "
        f"imports {marks[0][1] - t_start:.1f} s, {steps} s")
    # ---- the paced window ------------------------------------------------
    tracer = None
    if trace:
        # the profiled slice: the window's last seconds, ending at the close
        span = min(cell["profile_seconds"], seconds)
        tracer = Tracer(rt, cfg, seconds - span, span)
    rt0 = rt.open_window()
    state = {"closed": False}
    window = [dataclasses.replace(r, arrival=rt0 + r.arrival)
              for r in tr.window]
    index.on = True
    if tracer is not None:
        tracer.on = True

    def hook(now):
        w = now - rt0
        if not state["closed"] and w >= seconds:
            state["closed"] = True
            index.on = False
            if tracer is not None:
                tracer.on = False
    rt.hooks.append(hook)
    results = rt.serve(window, max_new_tokens=max_new)
    rt.paced = False
    index.on = False
    if tracer is not None:
        tracer.on = False
        tracer.finish()
    # ---- what the window did ---------------------------------------------
    by_id = {tl.req_id: tl for tl in rt.metrics.timelines.values()}
    reqs: List[record.Req] = []
    for r in tr.window:
        tl = by_id[r.req_id]
        first = tl.first_token - rt0 if tl.first_token >= 0 else None
        toks = ([first] if first is not None else []) + [
            x - rt0 for x in tl.token_times]
        prompt = sum(int(corpus.doc_lengths[d]) for d in tl.docs) \
            + len(r.question_tokens)
        reqs.append(record.Req(
            req_id=r.req_id, due=r.arrival, first=first, tokens=toks,
            prompt_tokens=prompt,
            hit_tokens=(tl.hit_tokens_gpu, tl.hit_tokens_host,
                        tl.hit_tokens_disk),
            queue_enter=(tl.queue_enter - rt0 if tl.queue_enter >= 0
                         else -1.0),
            prefill_start=(tl.final_prefill_start - rt0
                           if tl.final_prefill_start >= 0 else -1.0),
            finished=tl.finish >= 0 and len(toks) == max_new))
    run = record.Run(close=float(seconds), requests=reqs,
                     ttft_limit_s=_limit(cell.get("ttft_limit_ms")),
                     tpot_limit_s=_limit(cell.get("tpot_limit_ms")),
                     setup_s=setup_s, cfg=cfg)
    run.spans["search_s"] = list(index.searches)
    run.spans["stages"] = [index.stages, index.analytic_over]
    extra = {"open_half": sum(1 for r in reqs if r.due <= seconds / 2 and (
        r.first is None or r.first > seconds / 2)),
        "open_close": sum(1 for r in reqs if r.first is None
                          or r.first > seconds),
        "summary": rt.metrics.summary(),
        "sweep": {f"{n}_p{q}_ms": 1e3 * record.percentile(xs, q)
                  for n, xs in (("ttft", record.ttfts(run)),
                                ("tpot", record.tpots(run) or [0.0]))
                  for q in (50, 95)},
        "ttft_ms": [round(1e3 * x, 3) for x in record.ttfts(run)],
        "tpot_ms": [round(1e3 * x, 3) for x in record.tpots(run)]}
    if tracer is not None:
        run.spans["decode"] = tracer.decode
        run.spans["prefill"] = tracer.prefill
        run.trace = tracer.reduce()
        tracer.launches = {}
        tracer.prof = None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    # ---- the check, once the program's state is freed ---------------------
    sample = check.pick(results, reqs, corpus, tr.window, cell["check"],
                        traffic_mod.stream(seed, "sample"))
    del rt, tracer, results, index, window
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, ctl, extra["sample"] = check.compare(
        config, params, sample, cell["check"], control=control)
    return Result(run, checks, ctl, peak, n_blocks, n_warm, extra)


def _limit(ms) -> float:
    return math.inf if ms is None else ms / 1e3


def metrics_line(res: Result, names: List[Dict], rdrs: Dict) -> Dict:
    """{name: {value, unit}} of the metrics ``names`` (BENCHMARK.json
    entries) whose readers find something to read."""
    out = {}
    for m in names:
        value = rdrs[m["name"]].read(res.run)
        if value is None or not np.isfinite(value):
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
