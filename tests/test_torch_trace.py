"""The runtime's spans (``RuntimeMetrics.spans``) on a tiny paged runtime on
the CPU, with a GPU tier small enough to demote, a host tier small enough
to spill to disk, and requests served again so that nodes come back: every
span is recorded, phases nest in their engine step and steps in a handler,
the records hold only numbers, the ring keeps the newest, a profiler sees
only ``host:`` ranges, and the latest metrics outlive their runtime.

The serve runs on a runtime clock that steps ``STEP`` seconds a read (as
``test_torch_clock``'s skewed clock does): every iteration takes the same
virtual time, so the schedule (and with it every count, stale prefills
included) is the workload's alone, while the spans keep reading real
time."""
import collections
import dataclasses
import gc
import time
import types
import weakref

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import model as M
from repro_torch.retrieval.corpus import make_corpus, make_workload
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving import runtime as R
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.runtime import ContinuousRuntime
from test_torch_clock import shared_clock

torch.set_num_threads(2)

STEP = 0.01

STEPS = {"engine.decode": ("pack", "launch", "wait"),
         "engine.prefill": ("plan", "pack", "launch", "wait")}
HANDLERS = {"runtime." + k for k in ("arrival", "stage",
                                     "prefill_batch_done", "decode_done")}
TIERS = {"tree.demote", "tree.promote", "tree.spill", "tree.fetch"}
NAMES = (HANDLERS | TIERS | {"retrieval.search"} | set(STEPS)
         | {f"{s}.{p}" for s, ps in STEPS.items() for p in ps})


def _runtime(tmp_path):
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype="float32")
    params = M.init_params(cfg, 0, "cpu")
    corpus = make_corpus(16, mean_doc_tokens=24, vocab=cfg.vocab_size,
                         seed=0)
    idx = IVFIndex(corpus.doc_vectors, n_clusters=4, nprobe=2)
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 4     # f32 a token
    ec = EngineConfig(gpu_cache_bytes=160 * kv, host_cache_bytes=100 * kv,
                      disk_cache_bytes=10 ** 8, disk_cache_dir=str(tmp_path),
                      max_batch=4, max_prefill_bs=2, prefill_chunk=16,
                      max_prefill_tokens=64, block_size=8)
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=ec,
                           n_blocks=256, device="cpu")
    return rt, corpus, cfg


def _serve(rt, corpus, cfg, seeds=(1, 2, 3)):
    for seed in seeds:
        rt.serve(make_workload(corpus, n_requests=8, rate=200.0,
                               question_tokens=8, vocab=cfg.vocab_size,
                               zipf_s=1.0, seed=seed), max_new_tokens=3)


def _stepping_clock():
    t = [0.0]

    def perf_counter():
        t[0] += STEP
        return t[0]
    ns = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                  if not k.startswith("__")})
    ns.perf_counter = perf_counter
    return ns


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rt, corpus, cfg = _runtime(tmp_path_factory.mktemp("disk"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "time", _stepping_clock())
        _serve(rt, corpus, cfg)
    yield rt
    rt.disk.close()


def _end(sp):
    return sp.start_ns + sp.dur_ns


def _within(inner, outer):
    return outer.start_ns <= inner.start_ns and _end(inner) <= _end(outer)


def test_every_span_is_recorded(served):
    names = collections.Counter(sp.name for sp in served.metrics.spans)
    assert set(names) == NAMES, set(names) ^ NAMES
    assert served.metrics.spans_dropped == 0
    # measured_s is the runtime's reading: a step a stage here
    search = [sp for sp in served.metrics.spans
              if sp.name == "retrieval.search"]
    assert all(sp.attrs["stages"] > 0 and sp.attrs["floor_s"] > 0
               and sp.attrs["measured_s"] == pytest.approx(
                   STEP * sp.attrs["stages"]) for sp in search)


def test_the_constant_clock_does_not_reach_the_spans(tmp_path):
    """``shared_clock`` zeroes the runtime's measured times; the spans read
    their own clock."""
    rt, corpus, cfg = _runtime(tmp_path)
    with shared_clock():
        _serve(rt, corpus, cfg, seeds=(1,))
    rt.disk.close()
    spans = list(rt.metrics.spans)
    steps = [sp for sp in spans if sp.name in STEPS]
    assert steps and all(sp.dur_ns > 0 for sp in steps)
    assert all(sp.attrs["measured_s"] == 0.0 for sp in spans
               if sp.name == "retrieval.search")


def test_phases_nest_in_their_step_and_steps_in_a_handler(served):
    spans = list(served.metrics.spans)
    handlers = [sp for sp in spans if sp.name in HANDLERS]
    for step, phases in STEPS.items():
        steps = [sp for sp in spans if sp.name == step]
        for sp in spans:
            if sp.name.startswith(step + "."):
                assert sum(_within(sp, s) for s in steps) == 1, sp
        for s in steps:
            assert any(_within(s, h) for h in handlers), s
            inner = [sp for sp in spans if sp.name.startswith(step + ".")
                     and _within(sp, s)]
            if step == "engine.decode" or s.attrs["rows"]:
                # one of each phase, in order, inside the step
                assert [sp.name.rsplit(".", 1)[1] for sp in
                        sorted(inner, key=lambda x: x.start_ns)] == \
                    list(phases)
    for sp in spans:
        if sp.name in TIERS or sp.name == "retrieval.search":
            assert any(_within(sp, h) for h in handlers), sp
    promotes = [sp for sp in spans if sp.name == "tree.promote"]
    plans = [sp for sp in spans if sp.name == "engine.prefill.plan"]
    assert all(any(_within(p, q) for q in plans) for p in promotes)


def test_steps_count_as_the_summary_iterations(served):
    m = served.metrics
    s = m.summary()
    spans = list(m.spans)
    decode = [sp for sp in spans if sp.name == "engine.decode"]
    prefill = [sp for sp in spans if sp.name == "engine.prefill"]
    assert len(decode) == s["decode_iterations"]
    assert [sp.attrs["rows"] for sp in decode] == \
        [b for k, b in m.iterations if k == "decode"]
    ran = [sp for sp in prefill if sp.attrs["rows"]]
    assert len(ran) == s["prefill_iterations"]
    assert [sp.attrs["tokens"] for sp in ran] == \
        [t for _, t in m.prefill_batches]
    launches = [sp for sp in spans if sp.name == "engine.prefill.launch"]
    assert all(sp.attrs["B"] >= 2 and sp.attrs["Sq"] >= 8
               for sp in launches)
    pool = served.store.pool
    assert 0 < s["pool_blocks_peak"] <= pool.n_blocks
    assert s["pool_blocks_peak"] == max(sp.attrs["blocks"]
                                        for sp in decode + prefill)
    assert all(sp.attrs["longest"] > 0 for sp in decode)
    # a stale prefill computed tokens that no one used
    assert s["wasted_prefills"] + s["chunks_cancelled"] > 0
    assert 0 < s["wasted_prefill_tokens"] <= sum(
        t for _, t in m.prefill_batches)
    bytes_ = {sp.name: sp.attrs["bytes"] for sp in spans
              if sp.name in TIERS}
    assert all(b > 0 for b in bytes_.values())
    report = m.format_report()
    for name in NAMES:
        assert f"span {name} " in report
    assert f"wasted prefill tokens   : {s['wasted_prefill_tokens']}" \
        in report
    assert f"pool blocks peak in use : {s['pool_blocks_peak']}" in report


def test_records_hold_only_numbers(served):
    for sp in served.metrics.spans:
        # a closed span keeps no profiler range and no way back to its
        # metrics: only its name and numbers
        assert all(getattr(sp, k) is None or type(getattr(sp, k)) in
                   (str, int, float, bool, dict)
                   for k in type(sp).__slots__), sp
        assert type(sp.name) is str
        assert type(sp.start_ns) is int and type(sp.dur_ns) is int
        assert sp.dur_ns >= 0 and sp.profiled is False
        assert all(type(k) is str and type(v) in (int, float)
                   for k, v in sp.attrs.items()), sp


@pytest.mark.parametrize("capacity,n", [(4, 10), (8, 8)])
def test_the_ring_keeps_the_newest_and_counts_the_rest(capacity, n):
    m = R.RuntimeMetrics()
    assert m.spans.maxlen == R.SPAN_CAPACITY == 65536
    m.spans = collections.deque(maxlen=capacity)
    for i in range(n):
        with m.span(f"s{i}") as sp:
            sp.attrs = {"i": i}
    assert [sp.name for sp in m.spans] == \
        [f"s{i}" for i in range(max(0, n - capacity), n)]
    assert m.spans_dropped == max(0, n - capacity)


def test_a_span_closes_on_an_exception():
    m = R.RuntimeMetrics()
    with pytest.raises(KeyError):
        with m.span("failing"):
            raise KeyError("x")
    assert [sp.name for sp in m.spans] == ["failing"]


def test_profiler_ranges_are_host_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    rt, corpus, cfg = _runtime(tmp_path)
    _serve(rt, corpus, cfg, seeds=(1,))
    n0 = len(rt.metrics.spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(rt, corpus, cfg, seeds=(2,))
    _serve(rt, corpus, cfg, seeds=(3,))
    rt.disk.close()
    spans = list(rt.metrics.spans)
    inside = [sp for sp in spans[n0:] if sp.profiled]
    assert inside and all(not sp.profiled for sp in spans[:n0])
    assert not spans[-1].profiled
    names = {sp.name for sp in spans}
    seen = {e.name for e in prof.events()
            if any(n in e.name for n in names)}
    assert seen == {"host:" + sp.name for sp in inside}


def test_handler_spans_leave_out_what_wraps_the_handler(tmp_path):
    rt, corpus, cfg = _runtime(tmp_path)
    arrival = rt._on_arrival

    def paced(payload):             # as a pacing wrapper waits, outside
        time.sleep(0.2)
        return arrival(payload)
    rt._on_arrival = paced
    _serve(rt, corpus, cfg, seeds=(1,))
    rt.disk.close()
    spans = [sp for sp in rt.metrics.spans if sp.name == "runtime.arrival"]
    assert len(spans) == 8
    assert all(sp.dur_ns < 0.2e9 for sp in spans)


def test_the_latest_metrics_outlive_their_runtime(tmp_path):
    rt, corpus, cfg = _runtime(tmp_path)
    m = rt.metrics
    R.RuntimeMetrics()             # made, never served: not the latest
    _serve(rt, corpus, cfg, seeds=(1,))
    assert R.LATEST is m
    assert all(sp.start_ns >= m.serve_ns for sp in m.spans)
    rt.disk.close()
    gone = weakref.ref(rt)
    del rt
    gc.collect()
    assert gone() is None
    assert R.LATEST is m and len(m.spans) > 0
