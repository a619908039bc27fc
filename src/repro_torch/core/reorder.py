"""Cache-aware request reordering (paper §5.2).

OrderPriority = CachedLength / ComputationLength — serve requests whose hit
prefix is large relative to the compute they still need; a starvation window
guarantees any request is scheduled after at most ``window`` pops.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


@dataclasses.dataclass
class _Entry(Generic[T]):
    item: T
    cached_len: int
    compute_len: int
    seq: int
    skipped: int = 0

    @property
    def order_priority(self) -> float:
        return self.cached_len / max(self.compute_len, 1)


class ReorderQueue(Generic[T]):
    def __init__(self, window: int = 32, enabled: bool = True):
        self.window = window
        self.enabled = enabled
        self._entries: List[_Entry[T]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, item: T, cached_len: int, compute_len: int) -> None:
        self._entries.append(
            _Entry(item, cached_len, compute_len, next(self._seq))
        )

    def refresh(self, fn: Callable[[T], tuple]) -> None:
        """Re-evaluate (cached_len, compute_len) — hit lengths change as the
        tree evolves between arrival and scheduling."""
        for e in self._entries:
            e.cached_len, e.compute_len = fn(e.item)

    def peek_entry(self, viable: Optional[Callable[[T], bool]] = None
                   ) -> Optional["_Entry[T]"]:
        """The entry ``pop`` would select, WITHOUT removing it — callers that
        must check a resource fit (e.g. a prefill-token budget) peek first
        and only ``remove`` when the entry actually fits, so a non-fitting
        round does not disturb queue positions."""
        cands = (self._entries if viable is None
                 else [e for e in self._entries if viable(e.item)])
        if not cands:
            return None
        if not self.enabled:
            return min(cands, key=lambda e: e.seq)
        # starvation guard: anything skipped >= window times goes first
        starved = [e for e in cands if e.skipped >= self.window]
        if starved:
            return min(starved, key=lambda e: e.seq)
        return max(cands, key=lambda e: (e.order_priority, -e.seq))

    def remove(self, entry: "_Entry[T]", age: bool = True) -> None:
        """Remove a peeked entry; by default every remaining entry ages one
        skip (the same bookkeeping ``pop`` performs).  Callers popping
        several entries in ONE scheduling round pass ``age=False`` after the
        first so entries age exactly once per round, not once per pop."""
        self._entries.remove(entry)
        if age:
            for e in self._entries:
                e.skipped += 1

    def pop(self, viable: Optional[Callable[[T], bool]] = None) -> Optional[T]:
        """Remove and return the best entry. ``viable`` restricts the
        candidate set (e.g. admission control) without disturbing the
        queue position of non-viable entries."""
        best = self.peek_entry(viable)
        if best is None:
            return None
        self.remove(best)
        return best.item

    def bump_skipped(self, pred: Optional[Callable[[T], bool]] = None) -> None:
        """Count a scheduling round that passed (pred-matching) entries over
        without popping anything — admission-blocked rounds must still age
        entries toward the starvation window."""
        for e in self._entries:
            if pred is None or pred(e.item):
                e.skipped += 1

    def prune(self, drop: Callable[[T], bool]) -> int:
        """Remove entries for which ``drop(item)`` is true (cancelled
        speculations, finished requests). Returns how many were removed."""
        before = len(self._entries)
        self._entries = [e for e in self._entries if not drop(e.item)]
        return before - len(self._entries)

    def max_skipped(self, viable: Optional[Callable[[T], bool]] = None) -> int:
        """Largest skip count among (viable) entries — the scheduler's
        preemption trigger reads this to detect starving admissions."""
        cands = (self._entries if viable is None
                 else [e for e in self._entries if viable(e.item)])
        return max((e.skipped for e in cands), default=-1)

    def peek_all(self) -> List[T]:
        return [e.item for e in self._entries]
