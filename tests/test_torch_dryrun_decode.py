"""The compile analysis's decode over the reference's cache layout
(``launch/dryrun.py``, ``launch/sharding.py::cache_layout``).

A batch of 1 does not divide the data axes, so the cache's sequence splits
over them and each replica attends to its slice.  Replica 0 traced, the
others' slices standing on peer cards and their partial attention
standing in (``computed=1``), against every replica traced on a (4, 8)
mesh of 32 fake cards, where each card has its own device index: every
figure of replica 0's cards equal.  A small-mesh dry run's record puts
1 / (data x model) of the cache on a card, and no card's peak passes its
params, that share and one layer's part of K and V in f32 (the decode's
f32 reads of a layer).  The layout notes list no cache departure, the
recurrent decode state's included.
"""

import dataclasses
import json
import math

import pytest
import torch

torch.set_num_threads(2)

from repro_torch.configs import ASSIGNED, get_config, get_reduced
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as SH

FIGURES = ("flops", "dot_bytes", "coll", "coll_count", "bytes_out",
           "peak_bytes", "argument_bytes", "kernels")
BATCH1 = dict(kind="decode", seq=64, batch=1)


@pytest.mark.parametrize("arch,over,model", [
    ("qwen2-0.5b", {}, "hd"),
    ("qwen2-0.5b", dict(n_heads=8, n_kv_heads=8), "heads"),
    ("hymba-1.5b", {}, "hd"),
    ("gemma2-27b", {}, "hd")],
    ids=["qwen-hd", "qwen-heads", "hymba", "gemma2-softcap"])
def test_one_traced_replica_equals_the_whole_mesh_at_decode(arch, over,
                                                            model):
    """A batch-1 decode at one layer: the sequence over the 4 replicas,
    hd (or whole heads) over the 8 shards."""
    cfg = dataclasses.replace(get_reduced(arch), n_layers=1, **over)
    mesh = dryrun.fake_mesh(4, 8)
    assert SH.cache_layout(cfg, mesh, 1, 64) == SH.CacheLayout(1, 4, model)
    part, _ = dryrun.analyze_case(cfg, BATCH1, mesh)
    whole, _ = dryrun.analyze_case(cfg, BATCH1,
                                   dryrun.fake_mesh(4, 8, whole=True),
                                   computed=None)
    for m in range(8):
        dev = torch.device("meta", m)
        a, b = part.cards[dev].figures(), whole.cards[dev].figures()
        for k in FIGURES:
            assert a[k] == b[k], (arch, m, k, a[k], b[k])
    ctl = part.cards[torch.device("meta", 0)].coll
    assert ctl["all-reduce"] > 0 and ctl["all-gather"] > 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b"])
def test_a_batch_1_decode_spreads_its_cache(arch, tmp_path, monkeypatch):
    """``run_one`` of a decode of batch 1 at 4096 positions (in place of
    decode_32k's) on a (2, 4) mesh of fake cards: the record's K/V bytes
    on the busiest card are the cache's over data x model, and neither
    the controller nor a shard peaks past its params, its share of the
    cache and one layer's part of K and V in f32 (the controller also
    the new recurrent state the step builds, Hymba's "ssm")."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    small = dryrun.fake_mesh
    monkeypatch.setattr(dryrun, "fake_mesh",
                        lambda n_data, n_model, pods=1: small(2, 4))
    monkeypatch.setattr(specs, "SHAPES", dict(
        specs.SHAPES, decode_32k=dict(kind="decode", seq=4096, batch=1)))
    rec = dryrun.run_one(arch, "decode_32k", False, tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_reduced(arch)
    cache = 2 * cfg.n_layers * 4096 * cfg.n_kv_heads * cfg.hd * 2
    share = math.ceil(cache / 8)
    mem = rec["memory"]
    assert mem["kv_cache_bytes"] == share
    layer = 2 * share // cfg.n_layers          # one layer's K and V in f32
    params = sum(t.numel() * t.element_size() for t in
                 dryrun.M.init_params(cfg, 0, device="meta")["blocks"]
                 .values()) + 2 * cfg.vocab_size * cfg.d_model * 2
    state = mem["cache_bytes"] - share
    # Hymba's ssm lies hd over the 4 shards; Qwen2 has no state
    ssm = cfg.n_layers * cfg.n_heads * cfg.hd * cfg.ssm_state * 4
    assert mem["state_bytes"] == state == (ssm // 4 if cfg.ssm_state else 0)
    for card, held, new in (("controller", mem["cache_bytes"], state),
                            ("shard", share, 0)):
        fig = rec[card]
        assert fig["peak_bytes"] - (fig["argument_bytes"] - held) <= \
            held + layer + new, (card, fig, held, layer)
        assert fig["argument_bytes"] - held <= params
    saved = json.loads((tmp_path / f"{arch}__decode_32k__single.json")
                       .read_text())
    assert saved["memory"]["kv_cache_bytes"] == share


def test_layout_notes_list_no_cache_departure():
    """On the production mesh the notes keep the attention's and the
    prefill's and training forward's scans' departures and name no cache
    departure: neither the K/V's nor the recurrent decode state's."""
    mesh = dryrun.fake_mesh(16, 16)
    for arch in list(ASSIGNED) + ["llama2-70b"]:
        cfg = get_config(arch)
        notes = SH.layout_notes(cfg, mesh)
        text = " ".join(notes)
        assert "replica 0 alone" not in text and "splits its hd" not in text
        assert "cache lies" not in text and "cache's hd" not in text
        if cfg.family != "ssm" and not SH.kv_heads_shardable(cfg, 16):
            assert "attend on each replica's controller" in text, arch
        assert "their state there" not in text and "shard the state" \
            not in text, arch
        if cfg.family in ("ssm", "hybrid"):
            assert "the prefill's and the training forward's recurrent " \
                "scans" in text, arch
            assert "each shard steps its part" in text, arch
