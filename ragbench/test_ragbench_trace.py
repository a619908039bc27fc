"""The span readers on a traced CPU run at the tiny size: each reads a
finite number from the program's spans, none reads anything without them,
and a decode step's issue and wait add up to the benchmark's own timing of
it (``model.decode_step_ms``)."""
import math

import pytest
import torch

from ragbench import harness, record, tiny
from repro_torch.serving import runtime as R

# few threads, and a window long enough that decode steps fall in its
# unprofiled part even on a loaded host
torch.set_num_threads(2)

NEW = ("engine.decode_issue_ms", "engine.decode_wait_ms",
       "engine.prefill_issue_ms", "engine.prefill_wait_ms",
       "runtime.host_gap_share", "tree.tier_copy_share")


@pytest.fixture(scope="module")
def traced():
    res = harness.run_cell(tiny.cell(), tiny.config(), tiny.TRAFFIC,
                           seed=2**31 + 11, seconds=2.0, trace=True,
                           device="cpu")
    return res, harness.readers()


def test_the_span_readers_read_finite_numbers(traced):
    res, rd = traced
    got = {n: rd[n].read(res.run) for n in NEW}
    assert all(v is not None and math.isfinite(v) for v in got.values()), \
        got
    assert all(v > 0 for n, v in got.items() if n.endswith("_ms")), got
    assert 0 < got["runtime.host_gap_share"] < 100
    assert 0 <= got["tree.tier_copy_share"] < 100
    # the profiled slice's spans are flagged and left out
    assert any(s.profiled for s in R.LATEST.spans)


def test_decode_issue_and_wait_add_up_to_the_step(traced):
    res, rd = traced
    step = rd["model.decode_step_ms"].read(res.run)
    parts = rd["engine.decode_issue_ms"].read(res.run) \
        + rd["engine.decode_wait_ms"].read(res.run)
    assert parts <= step
    assert parts == pytest.approx(step, rel=0.05)


def test_nothing_to_read_without_spans(monkeypatch):
    run = record.Run(close=10.0, requests=[], ttft_limit_s=1.0,
                     tpot_limit_s=1.0)
    rd = harness.readers()
    monkeypatch.setattr(R, "LATEST", None)
    assert all(rd[n].read(run) is None for n in NEW)
    never = R.RuntimeMetrics()         # made, never served
    monkeypatch.setattr(R, "LATEST", never)
    assert all(rd[n].read(run) is None for n in NEW)
    never.stamp_serve()                 # served, but nothing in its window
    assert all(rd[n].read(run) is None for n in NEW)
