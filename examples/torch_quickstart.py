"""Quickstart on the PyTorch port: the RAGCache knowledge tree + PGDSF.

Builds a tiny model, caches two documents' KV in the tree, and shows that a
cache-hit prefill (a) skips the document computation and (b) gives the cold
path's logits bit for bit.  On the card each prefill's attention is the prefix
kernel (``kernels/csrc/prefix_attention.cu``); on the CPU its plain version.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import get_reduced
from repro_torch.core.controller import RAGController
from repro_torch.core.knowledge_tree import KnowledgeTree
from repro_torch.core.profiler import A10G_MISTRAL_7B, CostProfiler
from repro_torch.kernels import prefix_attention as PX
from repro_torch.models import model as M

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
device = torch.device(args.device)

cfg = get_reduced("qwen2-0.5b")
params = M.init_params(cfg, 0, device=device)


def tokens(seed, n):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (1, n), generator=gen)
    return ids.to(device)


# two "retrieved documents" and a user question (token ids)
doc1, doc2, question = tokens(1, 24), tokens(2, 24), tokens(3, 8)

# ---- cold request: compute everything, insert doc states into the tree ----
kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
tree = KnowledgeTree(
    gpu_capacity=1 << 20,
    host_capacity=1 << 22,
    profiler=CostProfiler.from_profile(A10G_MISTRAL_7B),
    bytes_per_token=kv_bytes,
)
ctl = RAGController(tree)

plan = ctl.plan([101, 202], [24, 24], question_tokens=8)
print(f"cold plan: cached={plan.alpha} tokens, to compute={plan.beta}")

with torch.no_grad():
    _, c1 = M.prefill(cfg, params, doc1)
    _, c12 = M.prefill(cfg, params, doc2, prefix_cache=c1, prefix_len=24)
    logits_cold, _ = M.prefill(cfg, params, question, prefix_cache=c12, prefix_len=48)
payload1 = {"k": c12["k"][:, :, :24], "v": c12["v"][:, :, :24]}
payload2 = {"k": c12["k"][:, :, 24:48], "v": c12["v"][:, :, 24:48]}
ctl.commit(plan, [payload1, payload2])

# ---- warm request: same docs -> prefix hit, question-only prefill ----------
plan2 = ctl.plan([101, 202], [24, 24], question_tokens=8)
print(f"warm plan: cached={plan2.alpha} tokens, to compute={plan2.beta}")
assert plan2.alpha == 48 and plan2.beta == 8

prefix = {
    key: torch.cat([n.payload_gpu[key] for n in plan2.hit_nodes], dim=2)
    for key in ("k", "v")
}
with torch.no_grad():
    logits_warm, _ = M.prefill(
        cfg, params, question, prefix_cache=prefix, prefix_len=48
    )
ctl.commit(plan2)

same = torch.equal(logits_cold, logits_warm)
print(f"cold-vs-warm logits bit-identical: {same} (exact reuse)")
print(f"doc hit rate so far: {ctl.doc_hit_rate:.0%}")
print(
    f"device {device}: prefix kernel launches "
    f"{PX.prefix_flash_attention.launches}, plain version calls "
    f"{PX.prefix_attention_torch.calls}"
)
assert same
print("OK")
