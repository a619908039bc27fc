"""Iterative retrieval (paper §9 / Related-work RAG): multi-hop RAG issues a
new retrieval per reasoning step.  "RAGCache supports iterative retrieval by
treating the intermediate iterations as separate requests and caching the
corresponding KV cache of the documents."

This module plans a multi-hop request as a chain of single-hop plans whose
document prefixes extend each other, so hop i+1's tree lookup hits the
entire [docs_1 .. docs_i] path that hop i just inserted.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

from repro_torch.core.controller import RAGController, RequestPlan


@dataclasses.dataclass
class HopResult:
    plan: RequestPlan
    alpha: int
    beta: int


def run_iterative(
    controller: RAGController,
    retrieve_fn: Callable[[int], Sequence[int]],   # hop index -> doc ids
    doc_tokens_fn: Callable[[int], int],           # doc id -> token count
    n_hops: int,
    question_tokens: int,
) -> List[HopResult]:
    """Plan+commit each hop; hop i's docs are appended to the running
    document path so the knowledge tree accumulates one branch per chain."""
    path: List[int] = []
    out: List[HopResult] = []
    for hop in range(n_hops):
        new_docs = [d for d in retrieve_fn(hop) if d not in path]
        docs = path + list(new_docs)
        toks = [doc_tokens_fn(d) for d in docs]
        plan = controller.plan(docs, toks, question_tokens)
        controller.promote(plan)
        controller.commit(plan)
        out.append(HopResult(plan=plan, alpha=plan.alpha, beta=plan.beta))
        path = docs
    return out
