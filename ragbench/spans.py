"""The program's own spans, as the span readers under ``metrics/`` take
them.

``repro_torch.serving.runtime.LATEST`` is the ``RuntimeMetrics`` of the
runtime that last entered ``serve()`` (the window's), kept after the
harness frees the runtime.  Its ``spans`` are closed spans on
``time.perf_counter_ns``: the handlers (``runtime.<kind>``), the engine
steps (``engine.decode`` / ``engine.prefill``) and their phases
(``.plan``, ``.pack``, ``.launch``, ``.wait``), the tree's tier copies
(``tree.*``) and the retrieval search.  A reader takes the spans that start
in the window, from the serve's stamp to the stamp plus ``run.close``, and
leaves out those recorded while the profiler ran, as the benchmark's own
step timings leave out the profiled slice.  Against a program that keeps
no spans every reader returns None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

STEPS = ("engine.decode", "engine.prefill")
TIERS = ("tree.demote", "tree.promote", "tree.spill", "tree.fetch")


def latest():
    """The window's RuntimeMetrics, or None."""
    try:
        from repro_torch.serving import runtime
    except ImportError:
        return None
    m = getattr(runtime, "LATEST", None)
    return m if m is not None and getattr(m, "serve_ns", None) else None


def _bounds(m, run) -> Tuple[int, int]:
    """The window on the spans' clock: the serve's stamp plus the close."""
    return m.serve_ns, m.serve_ns + int(run.close * 1e9)


def window(run) -> Optional[Tuple[list, float]]:
    """(the window's unprofiled spans, the window's unprofiled wall in
    seconds): the profiled part is the extent of the spans recorded while
    the profiler ran.  None without spans in the window."""
    m = latest()
    if m is None:
        return None
    t0, t1 = _bounds(m, run)
    inside = [s for s in m.spans if t0 <= s.start_ns < t1]
    prof = [s for s in inside if s.profiled]
    profiled = (min(t1, max(s.start_ns + s.dur_ns for s in prof))
                - min(s.start_ns for s in prof)) if prof else 0
    kept = [s for s in inside if not s.profiled]
    return (kept, (t1 - t0 - profiled) / 1e9) if kept else None


def steps(run, kind: str) -> List[Dict[str, float]]:
    """Each unprofiled ``kind`` step in the window that launched work on
    the device: its phases' milliseconds by phase name.  A phase closes
    before its step, so a step's phases are those of its kind recorded
    since the previous step of its kind."""
    m = latest()
    if m is None:
        return []
    t0, t1 = _bounds(m, run)
    out, phases, prefix = [], {}, kind + "."
    for s in m.spans:
        if s.name == kind:
            if t0 <= s.start_ns < t1 and not s.profiled \
                    and "launch" in phases:
                out.append(phases)
            phases = {}
        elif s.name.startswith(prefix):
            phases[s.name[len(prefix):]] = s.dur_ns / 1e6
    return out


def mean_of(run, kind: str, names) -> Optional[float]:
    """Mean over the window's ``kind`` steps of the sum of the phases
    ``names`` (ms)."""
    xs = [sum(p.get(n, 0.0) for n in names) for p in steps(run, kind)]
    return sum(xs) / len(xs) if xs else None
