"""95th percentile (ms) of the wait between a request's final documents
entering the scheduler's queue and the start of their prefill
(``RequestTimeline`` stamps, taken on the wall clock under pacing); a
request still queued at the close waits until it.  Layer: runtime and
scheduler."""
from ragbench import record


def read(run):
    xs = []
    for r in run.requests:
        if r.queue_enter < 0 or r.queue_enter > run.close:
            continue
        start = r.prefill_start if 0 <= r.prefill_start <= run.close \
            else run.close
        xs.append(max(0.0, start - r.queue_enter))
    return 1e3 * record.percentile(xs, 95) if xs else None
