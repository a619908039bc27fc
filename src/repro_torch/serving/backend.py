"""The ``Backend`` contract: the tier-hop surface every cache backend
implements (a copy of ``repro.serving.backend``).

In the port three classes implement it: ``PagedBackend``
(serving/runtime.py, the paged pool with its pinned host and raw-byte disk
tiers), ``TorchBackend`` (serving/engine.py, the sequential engine's
nested tensor payloads) and ``_SimBackend`` (serving/simulator.py, analytic
transfer times), each over ``core/knowledge_tree.py::CacheBackend``'s
duck-typed dispatch.  ``Backend`` names that surface as a
``typing.Protocol`` so that a misspelled hop (which would only surface as a
silently unfreed tier) fails ``conforms``.

Hop methods return the SECONDS the copy cost (measured wall time in the real
backends, analytic transfer time in the simulator's); free methods return
nothing.  ``demote_copy``/``promote_copy``/``free_tier`` are the generic
tier-indexed dispatchers the eviction cascade calls, so policy code never
names a tier pair.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Backend(Protocol):
    """Tier-hop surface of a knowledge-tree cache backend.

    Tier levels (core/knowledge_tree.py): 0 = GPU, 1 = host, 2 = disk.
    ``node`` is a ``knowledge_tree.Node`` whose ``payload_gpu`` /
    ``payload_host`` / ``payload_disk`` slots the backend moves between.
    """

    # ---- named hops (one per adjacent tier pair) -------------------------

    def swap_out(self, node) -> float:
        """GPU -> host copy; returns seconds."""
        ...

    def load(self, node) -> float:
        """host -> GPU copy; returns seconds.  May raise ``EvictionError``
        when the device tier cannot hold the payload (promotion degrades to
        recompute)."""
        ...

    def spill(self, node) -> float:
        """host -> disk write; returns seconds."""
        ...

    def fetch(self, node) -> float:
        """disk -> host read; returns seconds."""
        ...

    # ---- frees -----------------------------------------------------------

    def free_gpu(self, node) -> None: ...

    def free_host(self, node) -> None: ...

    def free_disk(self, node) -> None: ...

    # ---- generic tier-indexed dispatch (the cascade's entry points) ------

    def demote_copy(self, node, level: int) -> float:
        """Copy from tier ``level`` to tier ``level + 1``; returns seconds."""
        ...

    def promote_copy(self, node, level: int) -> float:
        """Copy from tier ``level`` to tier ``level - 1``; returns seconds."""
        ...

    def free_tier(self, node, level: int) -> None: ...


def conforms(obj) -> bool:
    """True when ``obj`` satisfies the ``Backend`` protocol (method presence
    — the runtime_checkable check; signatures are exercised by the
    conformance test's live calls)."""
    return isinstance(obj, Backend)
