"""The metric arithmetic on a hand-made record, and the readers by name."""
import json
from pathlib import Path

import numpy as np
import pytest

from ragbench import harness, record, roofline
from ragbench.tiny import REDUCED
from repro_torch.configs import get_config
import dataclasses

ROOT = Path(__file__).resolve().parent.parent


def hand_made():
    """Window 10 s, limits 1 s TTFT and 0.15 s TPOT, four tokens a request:
    a request well served, one late to its first token, one still decoding
    at the close, one with no first token at the close."""
    R = record.Req
    reqs = [
        R(0, due=1.0, first=1.5, tokens=[1.5, 1.6, 1.7, 1.8],
          prompt_tokens=100, hit_tokens=(60, 0, 0), queue_enter=1.1,
          prefill_start=1.2),
        R(1, due=2.0, first=4.0, tokens=[4.0, 4.1, 4.2, 4.3],
          prompt_tokens=100, hit_tokens=(0, 40, 0), queue_enter=2.1,
          prefill_start=3.9),
        R(2, due=9.0, first=9.5, tokens=[9.5, 9.9, 10.3, 10.7],
          prompt_tokens=100, queue_enter=9.1, prefill_start=9.2),
        R(3, due=9.8, first=10.4, tokens=[10.4, 10.5, 10.6, 10.7],
          prompt_tokens=100, queue_enter=9.9, prefill_start=10.2),
    ]
    return record.Run(close=10.0, requests=reqs, ttft_limit_s=1.0,
                      tpot_limit_s=0.15, setup_s=42.0)


def test_censored_ttft_tpot_and_goodput():
    run = hand_made()
    assert record.ttfts(run) == pytest.approx([0.5, 2.0, 0.5, 0.2])
    # request 2 is open at the close: censored there, (10 - 9.5) / 3
    assert record.tpots(run) == pytest.approx([0.1, 0.1, 0.5 / 3])
    assert record.good(run) == 1            # 1 is late, 2 and 3 unfinished
    rd = harness.readers()
    assert rd["ttft_p50_ms"].read(run) == pytest.approx(500.0)
    assert rd["ttft_p95_ms"].read(run) == pytest.approx(
        1e3 * np.percentile([0.5, 2.0, 0.5, 0.2], 95))
    assert rd["tpot_p95_ms"].read(run) == pytest.approx(
        1e3 * np.percentile([0.1, 0.1, 0.5 / 3], 95))
    assert rd["goodput_req_s"].read(run) == pytest.approx(0.1)
    assert rd["setup_s"].read(run) == 42.0
    # queue waits, request 3 still queued at the close: 0.1, 1.8, 0.1, 0.1
    assert rd["scheduler.queue_wait_ms_p95"].read(run) == pytest.approx(
        1e3 * np.percentile([0.1, 1.8, 0.1, 0.1], 95))
    # hit share over the three with a first token by the close
    assert rd["tree.hit_token_share"].read(run) == pytest.approx(
        100 * 100 / 300)


def test_layer_readers_on_spans_and_trace():
    cfg = dataclasses.replace(get_config("mistral-7b"), **REDUCED)
    run = hand_made()
    run.cfg = cfg
    rd = harness.readers()
    assert rd["retrieval.search_ms_p50"].read(run) is None
    assert rd["device.idle_share"].read(run) is None
    assert rd["moe.expert_share"].read(run) is None
    run.spans = {"search_s": [0.001, 0.003, 0.002],
                 "decode": [(0.02, [10, 20]), (0.04, [30])],
                 "prefill": [(0.5, [(0, 100), (64, 36)])]}
    run.trace = {"window_s": 2.0, "busy_s": 1.5, "device_s": 1.6,
                 "expert_s": 0.0, "kernel_s": {"prefill": 0.2, "decode": 0.1},
                 "bound_s": {"prefill": 0.05, "decode": 0.02}}
    assert rd["retrieval.search_ms_p50"].read(run) == pytest.approx(2.0)
    assert rd["scheduler.decode_batch_mean"].read(run) == pytest.approx(1.5)
    assert rd["model.decode_step_ms"].read(run) == pytest.approx(30.0)
    assert rd["device.idle_share"].read(run) == pytest.approx(25.0)
    assert rd["kernel.paged_prefill.roofline"].read(run) == pytest.approx(25)
    assert rd["kernel.paged_decode.roofline"].read(run) == pytest.approx(20)
    assert rd["moe.expert_share"].read(run) is None
    flops = roofline.prefill_flops(cfg, [(0, 100), (64, 36)])
    assert rd["mfu.prefill"].read(run) == pytest.approx(
        100 * flops / (0.5 * roofline.BF16_FLOPS_PER_S))
    dflops = roofline.decode_flops(cfg, [10, 20]) \
        + roofline.decode_flops(cfg, [30])
    assert rd["mfu.decode"].read(run) == pytest.approx(
        100 * dflops / (0.06 * roofline.BF16_FLOPS_PER_S))


def test_model_flops_count_tokens_not_implementation():
    cfg = dataclasses.replace(get_config("mistral-7b"), **REDUCED)
    D, F, V, L = 256, 512, 512, 2
    per_layer = D * 256 + 2 * D * 128 + 256 * D + 3 * D * F
    assert roofline.active_matmul_params(cfg) == L * per_layer
    # 100 tokens from 0 and 36 after 64 cached, window 64 in both layers
    pairs = sum(min(p + 1, 64) for p in range(100)) \
        + sum(min(p + 1, 64) for p in range(64, 100))
    assert roofline.prefill_flops(cfg, [(0, 100), (64, 36)]) == \
        2 * L * per_layer * 136 + 4 * 64 * 4 * pairs * L + 2 * D * V * 2
    moe = dataclasses.replace(get_config("mixtral-8x7b"), **REDUCED,
                              moe_experts=4)
    # two of the four experts count, and the router
    assert roofline.active_matmul_params(moe) == L * (
        D * 256 + 2 * D * 128 + 256 * D + 2 * 3 * D * F + D * 4)


def test_every_benchmark_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    rd = harness.readers()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["name"] in rd, m["name"]
    for w in bench["workloads"]:
        cell = harness.load("workloads", w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        harness.load("traffic", w["traffic"])
        c = harness.load("configs", w["config"])
        harness.port_config(c)
