"""The paced runtime against ``ContinuousRuntime.serve``: the same tokens
and the same tree decisions when the wall clock only waits for due times,
and a real wall clock on the runtime's axis when it runs."""
import dataclasses
import time
import types

import pytest

import repro_torch.serving.runtime as R
from ragbench import harness, tiny, traffic, weights
from ragbench.paced import PacedRuntime
from repro_torch.retrieval.vectordb import IVFIndex
from repro_torch.serving.config import EngineConfig


@pytest.fixture
def still_clock(monkeypatch):
    """The runtime measures every iteration and stage as taking no time,
    so its schedule depends on the workload alone."""
    ns = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                  if not k.startswith("__")})
    ns.perf_counter = lambda: 0.0
    monkeypatch.setattr(R, "time", ns)


def setup(moe):
    c = tiny.config(moe)
    cfg = harness.port_config(c)
    params = weights.draw(cfg, 9, "cpu")
    t = tiny.TRAFFIC
    tr = traffic.build(t, 4, 1.0, 14.0, cfg.vocab_size, n_warmup=8)
    idx = IVFIndex(tr.corpus.doc_vectors, n_clusters=t["ivf_clusters"],
                   nprobe=t["nprobe"], seed=t["base_seed"])
    e = c["engine"]
    ec = EngineConfig(gpu_cache_bytes=150 * 16 * cfg.n_layers * 2 * 2 * 64
                      * 4, host_cache_bytes=e["host_cache_bytes"],
                      top_k=2, max_batch=e["max_batch"],
                      max_prefill_tokens=e["max_prefill_tokens"])
    return cfg, params, tr, idx, ec


class FakeWall:
    def __init__(self):
        self.t = 100.0

    def clock(self):
        return self.t

    def sleep(self, s):
        self.t += s


def serve_both(rt, tr, paced):
    out = [rt.serve([dataclasses.replace(r, arrival=rt.now)
                     for r in tr.warmup], max_new_tokens=4)]
    if paced:
        rt.open_window()
    rt0 = rt.now
    out.append(rt.serve([dataclasses.replace(r, arrival=rt0 + r.arrival)
                         for r in tr.window], max_new_tokens=4))
    return out


@pytest.mark.parametrize("moe", [False, True], ids=["mistral", "mixtral"])
def test_paced_serves_what_the_runtime_serves(still_clock, moe):
    cfg, params, tr, idx, ec = setup(moe)
    base = R.ContinuousRuntime(cfg, params, tr.corpus, idx, config=ec,
                               n_blocks=320, device="cpu")
    wall = FakeWall()
    paced = PacedRuntime(cfg, params, tr.corpus, idx, config=ec,
                         n_blocks=320, device="cpu", clock=wall.clock,
                         sleep=wall.sleep)
    a = serve_both(base, tr, False)
    b = serve_both(paced, tr, True)
    for xs, ys in zip(a, b):
        assert [(x.req_id, x.tokens, x.docs, x.alpha, x.beta)
                for x in xs] == [(y.req_id, y.tokens, y.docs, y.alpha,
                                  y.beta) for y in ys]
    assert base.tree.stats == paced.tree.stats
    assert base.metrics.iterations == paced.metrics.iterations
    assert base.tree.stats["hits"] > 0
    assert paced.handlers == ["_on_arrival", "_on_decode_done",
                              "_on_prefill_batch_done", "_on_stage"]
    # the fake wall clock waited for every due time, and only for them
    assert wall.t == pytest.approx(100.0 + max(r.arrival
                                               for r in tr.window), abs=0.5)


def test_paced_now_follows_the_wall_clock():
    cfg, params, tr, idx, ec = setup(False)
    rt = PacedRuntime(cfg, params, tr.corpus, idx, config=ec, n_blocks=320,
                      device="cpu")
    seen = []
    rt.hooks.append(lambda now: seen.append((now, rt.wall())))
    rt0 = rt.open_window()
    t0 = time.perf_counter()
    res = rt.serve([dataclasses.replace(r, arrival=rt0 + r.arrival)
                    for r in tr.window], max_new_tokens=4)
    took = time.perf_counter() - t0
    assert took >= max(r.arrival for r in tr.window)
    # each handler ran at the wall clock's present, never before its event
    assert all(now <= wall for now, wall in seen)
    assert all(w - n < 0.05 for n, w in seen)
    by = {tl.req_id: tl for tl in rt.metrics.timelines.values()}
    for r in tr.window:
        assert by[r.req_id].first_token >= rt0 + r.arrival
    assert len(res) == len(tr.window)
