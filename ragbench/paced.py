"""``repro_torch``'s continuous runtime, run on the wall clock.

The runtime keeps a virtual clock: its event loop pops the next event, sets
``now`` to the event's time and calls ``_on_<kind>``; engine iterations push
their completion at ``now`` plus their measured wall time.  ``PacedRuntime``
wraps every ``_on_<kind>`` handler, found by name.  While it is paced, a
handler first waits until the wall clock reaches the event's due time, then
sets ``now`` to the wall clock, so host time between iterations, arrivals
that wait for the host, and retrieval stages all land where they happen.
The runtime's own ``serve`` loop runs unchanged.  Unpaced (the warm-up), it
is the program's virtual clock.

``hooks`` are called with ``now`` before each paced handler: the harness
closes the window and starts and stops the profiler there, between engine
iterations, where every iteration has already synchronised the device.
"""
from __future__ import annotations

import time
from typing import Callable, List

from repro_torch.serving.runtime import ContinuousRuntime


class PacedRuntime(ContinuousRuntime):
    def __init__(self, *args, clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep, **kwargs):
        super().__init__(*args, **kwargs)
        self.clock, self.sleep = clock, sleep
        self.paced = False
        self.hooks: List[Callable[[float], None]] = []
        self.rt0 = self._wall0 = 0.0
        self.handlers = sorted(n for n in dir(ContinuousRuntime)
                               if n.startswith("_on_"))
        for name in self.handlers:
            setattr(self, name, self._paced(getattr(self, name)))

    def wall(self) -> float:
        """The wall clock on the runtime's time axis."""
        return self.rt0 + (self.clock() - self._wall0)

    def open_window(self) -> float:
        """Start pacing: the runtime's present ``now`` becomes the wall
        clock's present.  Returns that time, the window's origin."""
        self.rt0, self._wall0 = self.now, self.clock()
        self.paced = True
        return self.rt0

    def _paced(self, handler):
        def run(payload):
            if self.paced:
                due = self.now
                ahead = due - self.wall()
                if ahead > 0:
                    self.sleep(ahead)
                self.now = max(due, self.wall())
                for hook in self.hooks:
                    hook(self.now)
            return handler(payload)
        return run
