"""The traced run's spans, counters and device trace.

Every span comes from the benchmark's own wrappers around calls into the
program's layers; nothing is added inside the program:

  * ``TimedIndex`` times each ``staged_search`` of the index the runtime is
    handed (the retrieval layer, on the host), stage by stage, beside the
    index's analytic stage cost;
  * the runtime's ``_decode`` and ``_run_paged_rows`` (one model step each,
    ending in a device synchronise) are timed with their rows, outside the
    profiled slice, whose recording slows the host;
  * while the profiler runs, ``ops.paged_prefill_attention`` and
    ``ops.paged_decode_attention`` keep each launch's run tables (read after
    the window, so nothing synchronises inside it), ``layers.swiglu`` runs
    under ``EXPERT_SPAN`` (``moe_dense`` calls it once an expert, as
    ``chip_smoke.py``'s expert span does), and every event handler and the
    pacing's wait run under a ``host:`` span, which names the host's work in
    each idle gap of the device.

The profiler covers ``[start, start + seconds)`` of the window (window
seconds), begun and ended between two events, where the device is idle and
no span is open.  Its stop parses the events, which stalls the event loop,
so the cells profile the window's last seconds and the parse falls after the
close.  It exports nothing: the events are reduced in memory.
"""
from __future__ import annotations

import bisect
import sys
import time
from typing import Dict, List, Optional

from ragbench import roofline

EXPERT_SPAN = "moe expert swiglu"
WAIT_SPAN = "host:wait for the next due event"


class TimedIndex:
    """The program's index with each ``staged_search`` timed."""

    def __init__(self, index):
        self.inner = index
        self.on = False
        self.searches: List[float] = []      # seconds a search, window only
        self.stages = 0
        self.analytic_over = 0               # stages whose analytic cost
                                             # exceeds the measured time

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def staged_search(self, q, k, *a, **kw):
        it = self.inner.staged_search(q, k, *a, **kw)
        total = 0.0
        while True:
            t0 = time.perf_counter()
            try:
                stage = next(it)
            except StopIteration:
                break
            dt = time.perf_counter() - t0
            total += dt
            if self.on:
                self.stages += 1
                self.analytic_over += stage.seconds > dt
            yield stage
        if self.on:
            self.searches.append(total)


class Tracer:
    """Installs the traced run's wrappers on a PacedRuntime and reads the
    profiler after the window."""

    def __init__(self, rt, cfg, start: float, seconds: float):
        import torch
        self.torch = torch
        self.rt, self.cfg = rt, cfg
        self.start, self.stop = start, start + seconds
        self.on = False
        self.prof = None
        self.profiling = False
        self.decode: List[tuple] = []        # (seconds, [row lengths])
        self.prefill: List[tuple] = []       # (seconds, [(q_start, n)])
        self.launches: Dict[str, list] = {"prefill": [], "decode": []}
        self.window_s = 0.0
        self._wrap_runtime()
        self._prime()

    def _prime(self):
        """The profiler's first start initialises the device's tracing,
        which takes seconds: do it before the window opens."""
        from torch.profiler import ProfilerActivity, profile
        x = self.torch.ones(8, device=self.rt.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            x.add_(1)
            if x.is_cuda:
                self.torch.cuda.synchronize(x.device)

    # ---- wrappers --------------------------------------------------------

    def _wrap_runtime(self):
        rt = self.rt
        decode, rows_fn = rt._decode, rt._run_paged_rows

        def timed_decode(batch):
            t0 = time.perf_counter()
            out = decode(batch)
            if self.on and not self.profiling:
                self.decode.append((time.perf_counter() - t0,
                                    [st.length + 1 for st in batch]))
            return out

        def timed_rows(rows):
            t0 = time.perf_counter()
            out = rows_fn(rows)
            if self.on and not self.profiling:
                self.prefill.append((time.perf_counter() - t0,
                                     [(int(r[4]), int(r[-1])) for r in rows]))
            return out

        rt._decode, rt._run_paged_rows = timed_decode, timed_rows
        for name in rt.handlers:
            setattr(rt, name, self._span(getattr(rt, name), f"host:{name}"))
        sleep = rt.sleep

        def wait(s):
            with self._maybe_span(WAIT_SPAN):
                sleep(s)
        rt.sleep = wait

    def _maybe_span(self, name):
        import contextlib
        if not self.profiling:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)

    def _span(self, fn, name):
        def run(payload):
            if self.rt.paced:
                self._toggle(self.rt.wall() - self.rt.rt0)
            with self._maybe_span(name):
                return fn(payload)
        return run

    def _patch_kernels(self, on: bool):
        from repro_torch.kernels import ops
        from repro_torch.models import layers as L
        if on:
            self._orig = (ops.paged_prefill_attention,
                          ops.paged_decode_attention, L.swiglu)
            pre, dec, swiglu = self._orig

            def prefill(q, k_pages, v_pages, tables, counts, starts, q_start,
                        q_len, layer, window, **kw):
                self.launches["prefill"].append(
                    (tuple(q.shape), q.element_size(), k_pages, tables,
                     counts, starts, q_start, q_len, int(window)))
                return pre(q, k_pages, v_pages, tables, counts, starts,
                           q_start, q_len, layer, window, **kw)

            def decode(q, k_pages, v_pages, tables, counts, starts, qpos,
                       layer, window, **kw):
                self.launches["decode"].append(
                    (tuple(q.shape), q.element_size(), k_pages, tables,
                     counts, starts, qpos, None, int(window)))
                return dec(q, k_pages, v_pages, tables, counts, starts, qpos,
                           layer, window, **kw)

            def expert(*a):
                with self.torch.profiler.record_function(EXPERT_SPAN):
                    return swiglu(*a)

            ops.paged_prefill_attention = prefill
            ops.paged_decode_attention = decode
            if self.cfg.moe_experts:
                L.swiglu = expert
        else:
            (ops.paged_prefill_attention, ops.paged_decode_attention,
             L.swiglu) = self._orig

    # ---- the profiled slice ---------------------------------------------

    def _toggle(self, t: float):
        """Start or stop the profiler at window time t, between two events
        and outside every span."""
        if not self.profiling and self.prof is None and t >= self.start:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self._patch_kernels(True)
            self.prof.start()
            self.profiling = True
            self._t0 = time.perf_counter()
        elif self.profiling and t >= self.stop:
            self.finish()

    def finish(self):
        if self.profiling:
            self.profiling = False
            self.window_s = time.perf_counter() - self._t0
            self.prof.stop()
            self._patch_kernels(False)

    # ---- after the window -------------------------------------------------

    def reduce(self) -> Optional[dict]:
        """Device time by kernel, busy and idle, the experts' span, the two
        paged kernels' device time and least time, and the idle gaps by the
        host span they fall in.  None when the profiler saw no device op."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        dev = [e for e in events if e.device_type != DeviceType.CPU
               and e.name != EXPERT_SPAN and not e.name.startswith("host:")]
        kinds = sorted({str(e.device_type) for e in events})
        print(f"[ragbench] profiler: {len(events)} events of {kinds}, "
              f"{len(dev)} on the device, over {self.window_s:.3f} s",
              file=sys.stderr, flush=True)
        if not dev or not cpu:
            return None
        # the slice on the profiler's clock: from its first event to its last
        w0 = min(e.time_range.start for e in events)
        w1 = max(e.time_range.end for e in events)
        iv = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                    for e in dev)
        iv = [(a, b) for a, b in iv if b > a]
        merged: List[list] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_us = sum(b - a for a, b in merged)
        by_name: Dict[str, float] = {}
        for e in dev:
            d = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + d
        # idle gaps, each named by the host span that covers most of it
        host = sorted(((e.time_range.start, e.time_range.end, e.name)
                       for e in events if e.device_type == DeviceType.CPU
                       and e.name.startswith("host:")))
        starts = [h[0] for h in host]
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        idle: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            best, cover = "host: none (the serve loop)", 0.0
            i = max(0, bisect.bisect_right(starts, a) - 4)
            while i < len(host) and host[i][0] < b:
                o = min(b, host[i][1]) - max(a, host[i][0])
                if o > cover:
                    best, cover = host[i][2], o
                i += 1
            idle[best] = idle.get(best, 0.0) + (b - a)
        expert_us = 0.0
        for ev in events:
            if ev.name == EXPERT_SPAN and ev.device_type == DeviceType.CPU:
                stack = [ev]
                while stack:
                    x = stack.pop()
                    expert_us += sum(k.duration for k in x.kernels)
                    stack.extend(x.cpu_children)
        kern = {k: sum(us for n, us in by_name.items() if f"paged_{k}_" in n)
                for k in ("prefill", "decode")}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": self.window_s, "busy_s": busy_us / 1e6,
            "device_s": sum(by_name.values()) / 1e6,
            "expert_s": expert_us / 1e6,
            "kernel_s": {k: v / 1e6 for k, v in kern.items()},
            "bound_s": {k: self.bound(k) for k in kern},
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps],
        }

    def bound(self, kind: str) -> float:
        """Sum of the least times of the launches of one kernel recorded
        while the profiler ran (run tables read here, after the window)."""
        total, memo = 0.0, {}
        for (q_shape, q_bytes, pages, tables, counts, starts, qa, qb,
             window) in self.launches[kind]:
            key = (id(counts), window)
            if key not in memo:
                c, s = counts.cpu().numpy(), starts.cpu().numpy()
                page = pages[0].shape[2] if isinstance(pages, list) \
                    else pages.shape[2]
                if kind == "decode":
                    pairs, keys = roofline.visible_pairs(
                        c, s, page, window, qpos=qa.cpu().numpy())
                else:
                    pairs, keys = roofline.visible_pairs(
                        c, s, page, window, q_start=qa.cpu().numpy(),
                        q_len=qb.cpu().numpy())
                memo[key] = (pairs, keys, tables.numel() + c.size + s.size)
            pairs, keys, n_int = memo[key]
            KV = pages[0].shape[3] if isinstance(pages, list) \
                else pages.shape[3]
            total += roofline.bound_s(q_shape, q_bytes, KV, n_int, pairs,
                                      keys)[0]
        return total

