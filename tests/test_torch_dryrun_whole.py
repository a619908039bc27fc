"""The compile analysis's coverage of the production meshes
(``launch/dryrun.py``): data replica 0 traced on its cards, every other
replica standing in on peer cards (``train_lib.sharded_loss_and_grads``
and ``optimizer.apply_updates_zero`` with ``computed``/``traced`` 1),
against every replica traced on a (4, 8) mesh of 32 fake cards, where
each card has its own device index: every figure of replica 0's cards
equal.
"""

import dataclasses

import pytest
import torch

torch.set_num_threads(2)

from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun

FIGURES = ("flops", "dot_bytes", "coll", "coll_count", "bytes_out",
           "peak_bytes", "argument_bytes", "kernels")


@pytest.mark.parametrize("arch,opts", [
    ("qwen2-0.5b", ()), ("mixtral-8x7b", ("moe-capacity",)),
    ("hymba-1.5b", ()), ("yi-34b", ("attn-fallback",))])
def test_one_traced_replica_equals_the_whole_mesh(arch, opts, monkeypatch):
    """Replica 0 traced, the others standing in on peer cards (the
    production meshes' coverage), against all 4 replicas traced on a
    (4, 8) mesh of 32 fake cards: every figure of replica 0's 8 cards, at
    one layer.  The stand-ins fetch no capacity counts, so the capacity
    case takes a dispatch chunk of one replica's tokens, as every
    production shape's replica fills whole chunks (16 x 4096 tokens for
    train_4k)."""
    from repro_torch.models import layers as L
    cfg, lay = dryrun.apply_opts(get_reduced(arch), opts)
    cfg = dataclasses.replace(cfg, n_layers=1)
    if arch == "yi-34b":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=2, head_dim=64)
    if cfg.moe_impl == "capacity":
        orig = L.moe_capacity_with
        monkeypatch.setattr(L, "moe_capacity_with", lambda *a, **kw: orig(
            *a, **dict(kw, token_chunk=64)))
    info = dict(kind="train", seq=32, batch=8)
    part, _ = dryrun.analyze_case(cfg, info, dryrun.fake_mesh(4, 8), lay)
    whole, _ = dryrun.analyze_case(cfg, info, dryrun.fake_mesh(4, 8,
                                                               whole=True),
                                   lay, computed=None)
    for m in range(8):
        dev = torch.device("meta", m)
        a, b = part.cards[dev].figures(), whole.cards[dev].figures()
        for k in FIGURES:
            assert a[k] == b[k], (arch, m, k, a[k], b[k])
