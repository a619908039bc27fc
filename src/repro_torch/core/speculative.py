"""Dynamic speculative pipelining (paper §5.3, Algorithm 2 + Theorem 5.1).

The vector search is split into stages; after each stage the provisional
top-k document list is pushed to the LLM engine as a *speculative* prefill.
A stale speculation (documents changed) is terminated after its current
iteration; a new one is admitted only while the pending-prefill pool has
room (``max_prefill_bs``), which keeps speculation off the critical path
under load (Theorem 5.1 cases 2/4).

This module holds the pure decision logic; the serving engine and the
discrete-event simulator both drive it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class SpecState:
    request_id: int
    current_docs: Optional[Tuple[int, ...]] = None   # docs of live speculation
    launched: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    wasted_launches: int = 0
    useful: bool = False


class SpeculativeController:
    """Algorithm 2: decide, per retrieval stage, whether to (re)launch a
    speculative generation for ``request_id`` with docs ``d_temp``."""

    def __init__(self, max_prefill_bs: int, enabled: bool = True):
        self.max_prefill_bs = max_prefill_bs
        self.enabled = enabled

    def on_stage(
        self,
        state: SpecState,
        d_temp: Tuple[int, ...],
        pool_size: int,
        *,
        is_final: bool = False,
    ) -> Tuple[str, Optional[Tuple[int, ...]]]:
        """Returns (action, docs):
          action ∈ {"keep", "terminate_and_launch", "launch", "terminate",
                    "none"} — what the engine should do with this request's
          speculation after this retrieval stage.
        """
        if not self.enabled:
            # No-DSP baseline: only act when the search is final.
            if is_final:
                return ("launch", d_temp)
            return ("none", None)

        if d_temp == state.current_docs:
            if state.current_docs is not None and is_final:
                state.useful = True
            return ("keep", None)

        # docs changed: terminate stale speculation after current iteration
        terminate = state.current_docs is not None
        # admit new speculation only if the prefill pool has room (Alg. 2 l.9)
        # — the *final* result is always admitted (it is real work, case 3).
        if is_final or pool_size < self.max_prefill_bs:
            if terminate:
                state.wasted_launches += 1
            state.current_docs = d_temp
            state.launched.append(d_temp)
            if is_final:
                state.useful = True
            return ("terminate_and_launch" if terminate else "launch", d_temp)
        if terminate:
            state.wasted_launches += 1
            state.current_docs = None
            return ("terminate", None)
        return ("none", None)


def staged_topk(
    scores_per_stage: Sequence[Sequence[Tuple[float, int]]],
    k: int,
) -> List[Tuple[int, ...]]:
    """Utility: given per-stage (score, doc_id) pools, produce the running
    top-k after each stage (lower score = closer, L2)."""
    pool: List[Tuple[float, int]] = []
    out: List[Tuple[int, ...]] = []
    for stage in scores_per_stage:
        pool.extend(stage)
        pool.sort()
        out.append(tuple(d for _, d in pool[:k]))
    return out
