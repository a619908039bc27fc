"""The PyTorch port's twins of ``examples/*.py`` (``examples/torch_*.py``)
on the CPU, each in a subprocess at a small size under its own time limit
(TIMEOUT seconds; two CPU threads a process, as the port's tests use: more
threads than cores slow the CPU's bf16 products by ~40x), printing its
claims.  Where a figure is fixed by host code and seeds alone it equals the
original's, computed here by the JAX package's host modules:

- quickstart: the plans (cached and computed tokens) of the original's
  controller, tree and profiler for the same documents;
- policy_ablation: the table of the JAX package's simulator on the same
  corpus and workload, fed the port's IVF index (the port's k-means runs in
  numpy and cannot reproduce ``jax.random``'s centroids, so the retrieved
  documents, and with them the table, would differ otherwise).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro.core.controller import RAGController as JaxController
from repro.core.knowledge_tree import KnowledgeTree as JaxTree
from repro.core.profiler import A10G_MISTRAL_7B as JAX_A10G
from repro.core.profiler import CostProfiler as JaxProfiler
from repro.retrieval.corpus import make_corpus as jax_corpus
from repro.retrieval.corpus import make_workload as jax_workload
from repro.serving.simulator import RAGSimulator as JaxSimulator
from repro.serving.simulator import SimConfig as JaxSimConfig
from repro_torch.configs import get_reduced
from repro_torch.retrieval.corpus import make_corpus
from repro_torch.retrieval.vectordb import IVFIndex

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = {"quickstart": 60, "rag_serving": 90, "train_tiny": 90,
           "policy_ablation": 60}
ABLATION_SIZE = (300, 60)          # docs, requests


def _run(name, *argv):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, str(ROOT / "examples"
                                            / f"torch_{name}.py"), *argv],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=TIMEOUT[name])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "OK" or name == "policy_ablation", r.stdout
    return r.stdout


def _plain_calls(out):
    """(kernel launches, plain-version calls) of the twin's last report."""
    m = re.search(r"device cpu: prefix kernel launches (\d+), plain version "
                  r"calls (\d+)", out)
    assert m, out
    return int(m.group(1)), int(m.group(2))


def _original_plans():
    """The original quickstart's two plan lines, from the JAX package's
    controller on the same documents."""
    cfg = get_reduced("qwen2-0.5b")
    tree = JaxTree(gpu_capacity=1 << 20, host_capacity=1 << 22,
                   profiler=JaxProfiler.from_profile(JAX_A10G),
                   bytes_per_token=2 * cfg.n_layers * cfg.n_kv_heads
                   * cfg.hd * 2)
    ctl = JaxController(tree)
    lines = []
    plan = ctl.plan([101, 202], [24, 24], question_tokens=8)
    lines.append(f"cold plan: cached={plan.alpha} tokens, "
                 f"to compute={plan.beta}")
    payload = {"k": np.zeros((cfg.n_layers, 1, 24, cfg.n_kv_heads, cfg.hd)),
               "v": np.zeros((cfg.n_layers, 1, 24, cfg.n_kv_heads, cfg.hd))}
    ctl.commit(plan, [payload, dict(payload)])
    plan = ctl.plan([101, 202], [24, 24], question_tokens=8)
    lines.append(f"warm plan: cached={plan.alpha} tokens, "
                 f"to compute={plan.beta}")
    return lines


def test_quickstart_twin():
    out = _run("quickstart", "--device", "cpu")
    want = _original_plans()
    assert want == ["cold plan: cached=0 tokens, to compute=56",
                    "warm plan: cached=48 tokens, to compute=8"]
    assert out.splitlines()[:2] == want
    assert "cold-vs-warm logits bit-identical: True" in out
    assert _plain_calls(out) == (0, 8)      # 4 prefills x 2 layers


def test_rag_serving_twin():
    out = _run("rag_serving", "--device", "cpu")
    assert "identical answers with/without cache: 10/10" in out
    m = re.search(r"hit rate: (\d+)% \((\d+)/10 requests had a prefix hit\)",
                  out)
    assert m and int(m.group(2)) > 0, out
    launches, calls = _plain_calls(out)
    assert launches == 0 and calls > 0


def test_train_tiny_twin():
    out = _run("train_tiny", "--device", "cpu", "--steps", "10")
    m = re.search(r"loss ([\d.]+) -> ([\d.]+)", out)
    assert m and float(m.group(2)) < float(m.group(1)), out
    # each step's forward and its remat recompute, 2 layers each
    assert _plain_calls(out) == (0, 40)


def _table(lines):
    rows = {}
    for ln in lines:
        parts = ln.split()
        if len(parts) == 4 and parts[0] in ("pgdsf", "gdsf", "lru", "lfu"):
            rows[parts[0]] = parts[1:]
    return rows


def test_policy_ablation_twin_matches_the_original_simulator():
    docs, requests = ABLATION_SIZE
    out = _run("policy_ablation", "--docs", str(docs), "--requests",
               str(requests))
    got = _table(out.splitlines())
    assert list(got) == ["pgdsf", "gdsf", "lru", "lfu"], out
    corpus = jax_corpus(docs, mean_doc_tokens=1000, seed=0)
    # the port's index on the same vectors (make_corpus is a copy)
    pcorpus = make_corpus(docs, mean_doc_tokens=1000, seed=0)
    assert np.array_equal(pcorpus.doc_vectors, corpus.doc_vectors)
    index = IVFIndex(pcorpus.doc_vectors, n_clusters=64, nprobe=8)
    wl = jax_workload(corpus, n_requests=requests, rate=0.8, zipf_s=1.0,
                      drift=0.15, seed=2)
    want = []
    for policy in ("pgdsf", "gdsf", "lru", "lfu"):
        cfg = JaxSimConfig(profile=JAX_A10G, policy=policy,
                           gpu_cache_bytes=int(0.25 * 2**30),
                           host_cache_bytes=2 * 2**30, reorder=False,
                           speculative=False)
        m = JaxSimulator(cfg, corpus, index, wl).run()
        want.append(f"{policy:>8} {m.doc_hit_rate:>9.3f} {m.avg_ttft:>8.3f}s "
                    f"{m.p99_ttft:>6.2f}s")
    assert got == _table(want)
