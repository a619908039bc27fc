"""Causal-LM training step (counterpart of ``repro.training.train_lib``).

``loss_fn`` projects to the vocabulary chunk by chunk: each ``seq_chunk``
tokens' logits, logsumexp and gold logit run under
``torch.utils.checkpoint``, so the (B, S, V) logits are never held (at
Qwen2-0.5B's vocabulary of 151,936 a batch of 8 x 1024 tokens would take
5.0 GB in f32); the backward recomputes each chunk's logits.  The model's
layers run under ``remat`` too.  On the card the forward's attention is
the prefix-attention kernel, its backward ``layers.flash_attention_bwd``.

``make_train_step(cfg, opt, mesh=)`` takes the step on a ``(data,
model)`` mesh (``launch/mesh.py::DeviceMesh``) in the training layout of
``launch/sharding.py::place_train``: the batch splits over the data axis
as ``batch_spec`` says, each replica runs the forward over its model
shards (``models/model.py::_Replica``), the loss is the global masked mean
(every replica's NLL sum over the global token count), and the grads are
summed over the replicas into ZeRO-1 slices
(``optimizer.apply_updates_zero``).  A capacity-dispatch MoE fills its
experts' buffers in the whole batch's token order across the replicas
(``models/model.py::CapacityDispatch``).  ``opts``: the layout options of
``launch/sharding.py::place_train``.

The compile analysis (``launch/dryrun.py``) runs the step with
``computed=1``: replica 0 computes its rows, and every other replica's
grads stand in as tensors of replica 0's shapes on its own devices, so
the update's transfers and memory are the whole mesh's while one
replica's work is traced (data replicas do the same work on their own
rows).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import (NO_OPTIONS, Options, batch_spec,
                                         leaf_at, train_dims)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            apply_updates,
                                            apply_updates_zero, tree_leaves,
                                            tree_map)


def _chunk_nll(cfg: ModelConfig, params, xc, lc, mc, mesh=None):
    """Masked NLL sum and mask sum of one chunk of hidden states."""
    logits = M.lm_logits(cfg, params, xc, mesh=mesh)    # (B, C, [K,] V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            seq_chunk: int = 512, attn_impl: str | None = None
            ) -> torch.Tensor:
    """Mean next-token NLL over the unmasked positions.  ``batch``:
    {"tokens", "labels" (B, S) or (B, K, S), optionally "loss_mask" of the
    labels' shape and "patch_embeds"}."""
    nll, cnt = nll_sums(cfg, params, batch, seq_chunk, attn_impl)
    return nll / torch.clamp(cnt, min=1.0)


def nll_sums(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
             seq_chunk: int = 512, attn_impl: str | None = None, mesh=None,
             opts: Options = NO_OPTIONS, dispatch=None, replica: int = 0):
    """(masked NLL sum, mask sum) of a batch, each summed chunk by chunk.
    ``mesh``: one data replica's mesh, ``params`` its training layout
    (``models/model.py::forward_hidden``, with ``opts``, ``dispatch`` and
    ``replica``)."""
    x = M.forward_hidden(cfg, params, batch, remat=True,
                         attn_impl=attn_impl, mesh=mesh, opts=opts,
                         dispatch=dispatch, replica=replica)  # (B, S, D)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.n_codebooks:
        labels = labels.movedim(1, 2)                   # (B, S, K)
        if mask is not None:
            mask = mask.movedim(1, 2)
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=x.device)
            if mask is None else mask.float().to(x.device))
    labels = labels.to(x.device)
    S = x.shape[1]
    chunk = min(seq_chunk, S)
    nll, cnt = [], []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        n, c = checkpoint(_chunk_nll, cfg, params, x[:, sl], labels[:, sl],
                          mask[:, sl], mesh, use_reentrant=False)
        nll.append(n)
        cnt.append(c)
    return torch.stack(nll).sum(), torch.stack(cnt).sum()


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


def _live(tree):
    """``tree`` (a placed tree, ``models/model.py::with_slices``'s: a leaf
    may be a tuple of shards or a ``DataSlices``) with every tensor
    detached and requiring grad, and the list of those tensors in
    ``tree_leaves`` order."""
    live = []

    def one(t):
        t = t.detach().requires_grad_(True)
        live.append(t)
        return t

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, M.DataSlices):
            return M.DataSlices(tuple(one(t) for t in node.parts), node.dim)
        if isinstance(node, tuple):
            return tuple(one(t) for t in node)
        return one(node)

    return walk(tree), live


def _refill(tree, it):
    """``tree``'s structure (a ``_live`` tree) filled from ``it``: a
    data-split leaf as a tuple, one part per replica's slice."""
    if isinstance(tree, dict):
        return {k: _refill(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, M.DataSlices):
        return tuple(next(it) for _ in tree.parts)
    if isinstance(tree, tuple):
        return tuple(next(it) for _ in tree)
    return next(it)


def _split_batch(cfg: ModelConfig, batch, mesh):
    """Each data replica's rows of ``batch`` (``batch_spec``: the data axis
    when it divides the batch), on its controller.  A batch the axis does
    not divide is replicated by the reference, every replica computing
    the same grads: it goes whole to replica 0 alone, which computes them
    once.  A list is taken as the replicas' rows, placed already."""
    if isinstance(batch, list):
        return batch
    B = batch["tokens"].shape[0]
    bax, n = batch_spec(cfg, B, mesh)
    if bax is None:
        n = 1
    return [{k: v.chunk(n)[d].to(mesh.replica(d).controller)
             for k, v in batch.items()} for d in range(n)]


def _count(parts, ctl) -> torch.Tensor:
    """The whole batch's mask sum (its label count without a mask), on
    ``ctl``, at least 1."""
    total = None
    for part in parts:
        mask = part.get("loss_mask")
        c = (torch.full((), float(part["labels"].numel()), device=ctl)
             if mask is None else mask.float().sum().to(ctl))
        total = c if total is None else total + c
    return torch.clamp(total, min=1.0)


def _stand_in(grads, params: list, d: int, dims, mesh, path=()):
    """Replica ``d``'s grads as empty tensors of ``grads``' shapes (replica
    0's) on replica ``d``'s devices: the compile analysis's stand-in for a
    replica it does not trace.  A data-split leaf's parts lie on their
    owners', each arriving as the traced step's would: every owner's slice
    copied to replica ``d``'s controller layer by layer (the forward's
    gathers) and its grad copied back (the backward's)."""
    out = {}
    for k in sorted(grads):
        g, at = grads[k], path + (k,)
        if isinstance(g, dict):
            out[k] = _stand_in(g, params, d, dims, mesh, at)
        elif dims[at].data_split:
            ctl = mesh.replica(d).controller
            parts = []
            for p in params:
                sl = leaf_at(p, at)
                part = torch.zeros_like(sl)
                for li in range(sl.shape[0]):
                    sl[li].to(ctl)
                    part[li] = torch.empty_like(sl[li], device=ctl).to(
                        sl.device)
                parts.append(part)
            out[k] = tuple(parts)
        elif isinstance(g, tuple):
            out[k] = tuple(torch.empty_like(t) for t in leaf_at(params[d], at))
        else:
            out[k] = torch.empty_like(leaf_at(params[d], at))
    return out


def sharded_loss_and_grads(cfg: ModelConfig, params: list, batch, mesh,
                           seq_chunk: int = 512,
                           attn_impl: str | None = None,
                           opts: Options = NO_OPTIONS, computed=None):
    """(loss, grads) on a ``(data, model)`` mesh: the global masked mean
    (the replicas' NLL sums over the whole batch's mask sum) on replica 0's
    controller, and each computing replica's grads of its share in its
    layout (a leaf's shards, a replicated leaf once, a data-split leaf one
    part per owner's slice), unsummed.  ``batch``: the whole batch, or
    the replicas' rows placed (a list).  ``computed``: how many replicas
    compute (the compile analysis's 1; the others' grads and shares stand
    in, ``_stand_in``)."""
    dims = train_dims(cfg, mesh, opts)
    parts = _split_batch(cfg, batch, mesh)
    ctl = mesh.replica(0).controller
    count = _count(parts, ctl)
    dispatch = (M.CapacityDispatch(len(parts)) if cfg.moe_experts
                and cfg.moe_impl == "capacity" and len(parts) > 1 else None)
    n_run = len(parts) if computed is None else computed
    loss, grads = None, []
    for d, part in enumerate(parts):
        row = mesh.replica(d)
        if d >= n_run:
            share = torch.zeros((), device=row.controller) \
                * count.to(row.controller)
            grads.append(_stand_in(grads[0], params, d, dims, mesh))
        else:
            tree, live = _live(M.with_slices(params, d, dims))
            nll, _ = nll_sums(cfg, tree, part, seq_chunk, attn_impl,
                              mesh=row, opts=opts, dispatch=dispatch,
                              replica=d)
            share = nll / count.to(nll.device)
            got = torch.autograd.grad(share, live, allow_unused=True)
            got = [torch.zeros_like(t) if g is None else g
                   for g, t in zip(got, live)]
            grads.append(_refill(tree, iter(got)))
        share = share.detach().to(ctl)
        loss = share if loss is None else loss + share
    return loss, grads


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    attn_impl: str | None = None, mesh=None,
                    opts: Options = NO_OPTIONS, computed=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``loss_and_grads``, then ``apply_updates``.
    Returns new params; the given ones are only read.

    ``mesh``: a ``(data, model)`` mesh; ``params`` is then
    ``launch/sharding.py::place_train``'s list (with ``opts``) and
    ``opt_state`` ``optimizer.init_state_zero``'s, and the step is
    ``sharded_loss_and_grads`` (``computed`` as there), then
    ``apply_updates_zero``."""
    if mesh is not None:
        dims = train_dims(cfg, mesh, opts)

        def sharded_step(params, opt_state: AdamWState, batch):
            loss, grads = sharded_loss_and_grads(
                cfg, params, batch, mesh, attn_impl=attn_impl, opts=opts,
                computed=computed)
            params, opt_state, gnorm = apply_updates_zero(
                opt, dims, mesh, params, grads, opt_state, traced=computed)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm}
        return sharded_step

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
