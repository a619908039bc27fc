"""Seeded weights in the port's parameter layout, drawn on the device.

The tree is ``repro_torch.models.model.init_params``'s (the leaves the paged
steps read), drawn by the benchmark itself so that the program and the plain
reference are handed the same tensors: one ``torch.Generator`` on the device,
one ``randn`` call a leaf, straight in the served dtype.  Projections are
normal(0, 0.02), the output projections (wo, wd) scaled by 1/sqrt(2 L) as the
port's init scales them, and the norm offsets normal(0, 0.02) (the port's
RMSNorm multiplies by 1 + offset), so the reference's norms are checked too.
"""
from __future__ import annotations

import torch

SCALE = 0.02


def draw(cfg, seed: int, device) -> dict:
    if cfg.family not in ("dense", "moe") or cfg.qkv_bias \
            or cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: the benchmark draws untied dense and "
                         f"MoE decoders without biases only")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    out_scale = SCALE / (2 * cfg.n_layers) ** 0.5

    def leaf(name, shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=cfg.tdtype)
        return w.mul_(out_scale if name in ("wo", "wd") else SCALE)

    D, F, V, nl = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    H, KV, hd, E = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.moe_experts
    blocks = {"ln1": (nl, D), "wq": (nl, D, H * hd), "wk": (nl, D, KV * hd),
              "wv": (nl, D, KV * hd), "wo": (nl, H * hd, D), "ln2": (nl, D)}
    if E:
        blocks.update(router=(nl, D, E), wg=(nl, E, D, F), wu=(nl, E, D, F),
                      wd=(nl, E, F, D))
    else:
        blocks.update(wg=(nl, D, F), wu=(nl, D, F), wd=(nl, F, D))
    params = {k: leaf(k, s) for k, s in
              (("embed", (V, D)), ("final_norm", (D,)), ("lm_head", (D, V)))}
    params["blocks"] = {k: leaf(k, s) for k, s in blocks.items()}
    return params
