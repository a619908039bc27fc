"""Causal-LM training step (counterpart of ``repro.training.train_lib``).

``loss_fn`` projects to the vocabulary chunk by chunk: each ``seq_chunk``
tokens' logits, logsumexp and gold logit run under
``torch.utils.checkpoint``, so the (B, S, V) logits are never held (at
Qwen2-0.5B's vocabulary of 151,936 a batch of 8 x 1024 tokens would take
5.0 GB in f32); the backward recomputes each chunk's logits.  The model's
layers run under ``remat`` too.  On the card the forward's attention is
the prefix-attention kernel, its backward ``layers.flash_attention_bwd``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            apply_updates, tree_leaves,
                                            tree_map)


def _chunk_nll(cfg: ModelConfig, params, xc, lc, mc):
    """Masked NLL sum and mask sum of one chunk of hidden states."""
    logits = M.lm_logits(cfg, params, xc)               # (B, C, [K,] V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            seq_chunk: int = 512, attn_impl: str | None = None
            ) -> torch.Tensor:
    """Mean next-token NLL over the unmasked positions.  ``batch``:
    {"tokens", "labels" (B, S) or (B, K, S), optionally "loss_mask" of the
    labels' shape and "patch_embeds"}."""
    x = M.forward_hidden(cfg, params, batch, remat=True,
                         attn_impl=attn_impl)          # (B, S, D)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.n_codebooks:
        labels = labels.movedim(1, 2)                   # (B, S, K)
        if mask is not None:
            mask = mask.movedim(1, 2)
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    S = x.shape[1]
    chunk = min(seq_chunk, S)
    nll, cnt = [], []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        n, c = checkpoint(_chunk_nll, cfg, params, x[:, sl], labels[:, sl],
                          mask[:, sl], use_reentrant=False)
        nll.append(n)
        cnt.append(c)
    return torch.stack(nll).sum() / torch.clamp(torch.stack(cnt).sum(),
                                                min=1.0)


def loss_and_grads(cfg: ModelConfig, params, batch, seq_chunk: int = 512,
                   attn_impl: str | None = None):
    """(loss, grads): ``loss_fn``'s value and its gradient for every param,
    in the params' tree (``jax.value_and_grad`` of the reference)."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(live)
    loss = loss_fn(cfg, tree_map(lambda _: next(it), params), batch,
                   seq_chunk=seq_chunk, attn_impl=attn_impl)
    it = iter(torch.autograd.grad(loss, live))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    attn_impl: str | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``loss_and_grads``, then ``apply_updates``.
    Returns new params; the given ones are only read."""
    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(cfg, params, batch, attn_impl=attn_impl)
        params, opt_state, gnorm = apply_updates(opt, params, grads,
                                                 opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_serve_step(cfg: ModelConfig):
    """One decode iteration over a preallocated dense cache."""
    def serve_step(params, tokens, cache, pos):
        return M.decode_step(cfg, params, tokens, cache, pos)
    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """The serving prefill of a batch {"tokens", optionally
    "patch_embeds"} from position 0."""
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch["tokens"],
                         patch_embeds=batch.get("patch_embeds"))
    return prefill_step
