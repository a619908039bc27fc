"""The plain reference against the port's logits on the reduced configs,
and the frozen roofline arithmetic against chip_smoke.py's."""
import numpy as np
import pytest
import torch

import chip_smoke
from ragbench import check, harness, roofline, tiny, weights
from ragbench.reference import Reference
from repro_torch.models import model as M


@pytest.mark.parametrize("moe", [False, True], ids=["mistral", "mixtral"])
def test_reference_matches_the_port(moe):
    c = tiny.config(moe)
    cfg = harness.port_config(c)
    params = weights.draw(cfg, 123, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 150),
                         generator=torch.Generator().manual_seed(1))
    want = M.forward(cfg, params, toks)[0]
    got = Reference(c, params).logits([toks[0]], [0])[0]
    scale = want.abs().max().item()
    assert scale > 0.1
    assert (got - want).abs().max().item() <= 1e-4 * scale
    # the float8 control is measurably away from both
    ctl = Reference(c, params, fp8=True).logits([toks[0]], [0])[0]
    assert (ctl - want).abs().max().item() > 100 * 1e-4 * scale


def test_readings_of_exact_tokens_are_zero_and_of_altered_ones_not():
    c = tiny.config()
    cfg = harness.port_config(c)
    params = weights.draw(cfg, 5, "cpu")
    prompt = np.arange(40, dtype=np.int64) % cfg.vocab_size
    seq = torch.from_numpy(prompt)
    served = []
    for _ in range(4):
        lg = Reference(c, params).logits([seq], [len(seq) - 1])[0][-1]
        served.append(int(lg.argmax()))
        seq = torch.cat([seq, torch.tensor([served[-1]])])
    first = Reference(c, params).logits(
        [torch.from_numpy(prompt)], [39])[0][0].numpy()
    s = {"prompt": prompt, "served": np.asarray(served), "first_logits": first}
    got, _ = check.readings(c, params, [s])
    assert got["token_gap"] == 0.0 and got["first_logit_err"] < 1e-5
    bad = dict(s, served=np.asarray(served) ^ 1)
    got, _ = check.readings(c, params, [bad])
    assert got["token_gap"] > 0.0


def _case(decode: bool):
    rng = np.random.default_rng(0)
    L, n_pages, page, KV, hd, H = 2, 40, 16, 2, 64, 8
    B, n_slots = 3, 6
    tables = rng.integers(1, n_pages, (B, n_slots)).astype(np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    lens = [70, 33, 0]
    for b, n in enumerate(lens):
        k = -(-n // page)
        counts[b, :k] = [min(page, n - j * page) for j in range(k)]
        starts[b, :k] = np.arange(k) * page
    t = torch.from_numpy
    case = dict(k_pages=torch.zeros((L, n_pages, page, KV, hd),
                                    dtype=torch.bfloat16),
                tables=t(tables), counts=t(counts), starts=t(starts),
                window=24)
    if decode:
        case["q"] = torch.zeros((B, H, hd), dtype=torch.bfloat16)
        case["qpos"] = t(np.array([69, 32, 0], np.int32))
    else:
        case["q"] = torch.zeros((B, H, 32, hd), dtype=torch.bfloat16)
        case["q_start"] = t(np.array([50, 10, 0], np.int32))
        case["q_len"] = t(np.array([20, 23, 0], np.int32))
    return case


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_roofline_counts_match_chip_smoke(decode):
    case = _case(decode)
    want_pairs = chip_smoke.visible_pairs(np, case, decode)
    c = {k: v.numpy() for k, v in case.items()
         if isinstance(v, torch.Tensor) and v.dtype == torch.int32}
    kw = ({"qpos": c["qpos"]} if decode
          else {"q_start": c["q_start"], "q_len": c["q_len"]})
    got = roofline.visible_pairs(c["counts"], c["starts"], 16, 24, **kw)
    assert got == want_pairs and got[0] > 0
    want_ms, want_by = chip_smoke.bound_ms(np, case, decode)
    n_int = sum(case[n].numel() for n in ("tables", "counts", "starts"))
    got_s, got_by = roofline.bound_s(tuple(case["q"].shape), 2, 2, n_int,
                                     *got)
    assert got_by == want_by
    assert got_s * 1e3 == pytest.approx(want_ms, rel=1e-12)
