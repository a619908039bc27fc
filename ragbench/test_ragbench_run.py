"""Whole runs of the harness: on the CPU at a tiny size (the look for a
card skipped), sound, with a served token altered where the decode step
produces it, and with the float8 control; on the card, the control at the
cells' own sizes."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.serving.runtime as R
from ragbench import check, harness, tiny

ROOT = Path(__file__).resolve().parent.parent

RUN = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from ragbench import check, harness, tiny
res = harness.run_cell(tiny.cell(), tiny.config(), tiny.TRAFFIC, seed=77,
                       seconds=0.8, trace=True, device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "repro"}}), check.correct(res.checks))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(src=str(ROOT / "src"),
                                          root=str(ROOT))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.parametrize("fault", [None, "token"])
def test_correct_is_false_when_a_served_token_is_altered(monkeypatch, fault):
    if fault == "token":
        decode = R.ContinuousRuntime._decode

        def altered(self, batch):
            toks = decode(self, batch)
            return (toks + 1) % self.cfg.vocab_size
        monkeypatch.setattr(R.ContinuousRuntime, "_decode", altered)
    res = harness.run_cell(tiny.cell(), tiny.config(), tiny.TRAFFIC,
                           seed=2**31 + 3, seconds=0.8, trace=False,
                           device="cpu", control=fault is None)
    assert sum(res.extra["sample"]["kinds"].values()) == 4
    if fault is None:
        assert check.correct(res.checks)
        # the float8 control fails the limits the program keeps
        assert any(res.control[n] > c["limit"]
                   for n, c in res.checks.items())
    else:
        assert not check.correct(res.checks)
        assert res.checks["token_gap"]["value"] > \
            res.checks["token_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mistral7b.rag-zipf"])
def test_control_fails_on_the_card(cell):
    """The float8 control, read on each run's sample at the cell's own size
    on three seeds, fails a limit that the program keeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        out = subprocess.run(
            [sys.executable, "ragbench/run.py", "--workload", cell, "--seed",
             str(seed), "--seconds", "10", "--trace", "0", "--control"],
            capture_output=True, text=True, timeout=900, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        info = [x for x in out.stderr.splitlines()
                if x.startswith("[ragbench] {")][-1]
        ctl = json.loads(info[len("[ragbench] "):])["control"]
        assert any(ctl[n] > c["limit"] for n, c in line["checks"].items())
