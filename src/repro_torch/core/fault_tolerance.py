"""Fault tolerance (paper §6).

Two mechanisms:
  * hot-node replication — a GPU failure invalidates every device-tier node
    (prefix sensitivity makes children unusable without parents), so the most
    frequently accessed upper-level nodes keep a host-memory replica even
    while resident in GPU; recovery re-seeds the tree from those replicas.
  * request retry — a request that fails before its first iteration is
    recomputed from scratch; afterwards it resumes from the stored states.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.core.knowledge_tree import KnowledgeTree, Node


def replicate_hot_nodes(tree: KnowledgeTree, budget_bytes: int) -> int:
    """Copy the highest-frequency GPU-resident upper-level nodes into host
    memory (top-down, so every replica's parent is replicated first).
    Returns bytes replicated. Uses the swap-out path, so a later GPU
    eviction of these nodes is a zero-copy free."""
    done = 0
    frontier: List[Node] = [c for c in tree.root.children.values() if c.in_gpu]
    while frontier and done < budget_bytes:
        frontier.sort(key=lambda n: -n.frequency)
        node = frontier.pop(0)
        if not node.in_host:
            if tree.host_used + node.bytes_ > tree.host_capacity:
                tree.evict_host(node.bytes_)
            if tree.host_used + node.bytes_ > tree.host_capacity:
                break
            tree.backend.swap_out(node)
            node.in_host = True
            node.swapped_once = True
            tree.host_used += node.bytes_
            done += node.bytes_
        kids = [c for c in node.children.values() if c.in_gpu]
        kids.sort(key=lambda n: -n.frequency)
        frontier.extend(kids)
    return done


def _drop_cold_copies(tree: KnowledgeTree, n: Node) -> None:
    """Free a node's host and disk copies (with accounting) — the slower
    tiers are worthless once the node is unreachable from a cached parent."""
    if n.in_host:
        tree.backend.free_host(n)
        n.in_host = False
        n.swapped_once = False
        tree.host_used -= n.bytes_
    if n.in_disk:
        tree.backend.free_disk(n)
        n.in_disk = False
        n.spilled_once = False
        tree.disk_used -= n.bytes_


def recover_from_gpu_failure(tree: KnowledgeTree) -> Tuple[int, int]:
    """Simulated device loss: every GPU-tier payload is gone.  Nodes with a
    host or disk copy survive (demoted off the device); the rest are freed,
    and slower-tier state stranded under a lost parent is reclaimed too —
    match_prefix can never reach it again, so keeping it (or its mmap
    segment files) would be a permanent leak.  Returns (nodes_recovered,
    nodes_lost).  Tier invariants hold afterwards."""
    recovered = lost = 0
    # top-down so a node's fate can depend on its parent's outcome (a lost
    # parent dooms the whole subtree, however many replicas it holds)
    nodes = sorted(tree.nodes(), key=lambda n: len(n.path()))
    dropped: List[Node] = []
    for n in nodes:
        parent_ok = n.parent is tree.root or n.parent.cached
        if not n.in_gpu:
            if n.cached and not parent_ok:
                _drop_cold_copies(tree, n)   # orphaned by a lost ancestor
                lost += 1
                dropped.append(n)
            continue
        n.payload_gpu = None
        n.in_gpu = False
        tree.gpu_used -= n.bytes_
        if (n.in_host or n.in_disk) and parent_ok:
            recovered += 1
        else:
            _drop_cold_copies(tree, n)
            lost += 1
            dropped.append(n)
    for n in dropped:
        tree._maybe_prune(n)
    return recovered, lost


@dataclasses.dataclass
class RetryPolicy:
    max_attempts: int = 3
    timeout_s: float = 30.0


def serve_with_retry(serve_fn: Callable[[], object],
                     policy: RetryPolicy = RetryPolicy()):
    """Timeout/retry wrapper for request processing (paper §6: requests
    failing before their first iteration are recomputed)."""
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        t0 = time.time()
        try:
            return serve_fn()
        except Exception as e:  # noqa: BLE001
            last = e
            if time.time() - t0 > policy.timeout_s:
                break
    raise RuntimeError(
        f"request failed after {policy.max_attempts} attempts") from last
