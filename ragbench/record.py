"""What one run records, and the end-to-end arithmetic over it.

Times are seconds on the window's axis: 0 is the window's opening, ``close``
its end.  A request is due in the window by construction (its arrival).  A
request with no first token at the close enters the TTFT tail at its age at
the close; one with a first token but not finished is censored at the close
for TPOT, as if its last token came then.  The drain after the close is served but not timed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Req:
    req_id: int
    due: float
    first: Optional[float]         # first token, None if never
    tokens: List[float]            # every token's time, the first included
    prompt_tokens: int = 0
    hit_tokens: tuple = (0, 0, 0)  # (gpu, host, disk) of the final prefill
    queue_enter: float = -1.0
    prefill_start: float = -1.0
    finished: bool = True          # every token served (by the drain)


@dataclasses.dataclass
class Run:
    close: float                   # window seconds
    requests: List[Req]
    ttft_limit_s: float
    tpot_limit_s: float
    setup_s: float = 0.0
    cfg: object = None
    # harness spans and counters, filled in traced runs
    spans: Dict[str, list] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None


def ttft(r: Req, close: float) -> float:
    if r.first is not None and r.first <= close:
        return r.first - r.due
    return close - r.due


def tpot(r: Req, close: float) -> Optional[float]:
    """(last - first) / (tokens - 1); a request still decoding at the close
    is censored there, as if its last token came at the close (a lower
    bound on its TPOT).  None without a first token by the close."""
    if r.first is None or r.first > close:
        return None
    last = r.tokens[-1] if finished_by(r, close) else close
    return (last - r.first) / max(len(r.tokens) - 1, 1)


def finished_by(r: Req, close: float) -> bool:
    return r.finished and r.tokens[-1] <= close


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def ttfts(run: Run) -> List[float]:
    return [ttft(r, run.close) for r in run.requests]


def tpots(run: Run) -> List[float]:
    out = [tpot(r, run.close) for r in run.requests]
    return [t for t in out if t is not None]


def good(run: Run) -> int:
    """Requests that finished by the close within both limits."""
    return sum(1 for r in run.requests
               if finished_by(r, run.close)
               and ttft(r, run.close) <= run.ttft_limit_s
               and tpot(r, run.close) <= run.tpot_limit_s)
