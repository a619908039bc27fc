"""How ``correct`` is decided: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of the
window's requests, drawn from the seed, is read again by the float32
reference (reference.py) over each prompt (the final documents and the
question, as served) followed by the tokens the program served.  The sample
holds the request with the longest prompt, and as many as it can of each
path the first token came by: a prefix from the GPU tier, from the host
tier, and no cached prefix.  Two numbers are compared, each with its limit
(the cell's ``check.limits``, set from readings, see PERF.md):

  * ``token_gap``: the widest gap by which a served token's reference logit
    lies below the reference's best at that position, over every sampled
    token (the first token, then the paged decode's);
  * ``first_logit_err``: the largest |program - reference| first-token
    logit (``RuntimeResult.first_logits``) over the sampled requests.

The control puts the reference computed through float8 (``fp8=True``) in the
program's place: its first-token logits, and at each position the token it
puts first, read against the float32 reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _kind(hit_tokens) -> str:
    gpu, host, disk = hit_tokens
    if host or disk:
        return "host"
    return "gpu" if gpu else "none"


def pick(results, reqs, corpus, window, spec: Dict, rng) -> List[Dict]:
    """The sampled requests: prompt tokens, served tokens, the program's
    first-token logits and the path of the prefix."""
    res = {r.req_id: r for r in results}
    due = {r.req_id: r for r in window}
    done = [q for q in reqs if q.finished and res[q.req_id].tokens]
    if not done:
        return []
    chosen = [max(done, key=lambda q: q.prompt_tokens).req_id]
    by_kind: Dict[str, List[int]] = {}
    for q in done:
        by_kind.setdefault(_kind(q.hit_tokens), []).append(q.req_id)
    for kind in ("gpu", "host", "none"):
        ids = [i for i in by_kind.get(kind, []) if i not in chosen]
        take = min(spec["per_kind"], len(ids))
        chosen += [ids[j] for j in rng.choice(len(ids), take, replace=False)]
    rest = [q.req_id for q in done if q.req_id not in chosen]
    more = min(spec["sample"] - len(chosen), len(rest))
    if more > 0:
        chosen += [rest[j] for j in rng.choice(len(rest), more,
                                               replace=False)]
    kinds = {q.req_id: _kind(q.hit_tokens) for q in reqs}
    out = []
    for i in chosen:
        r = res[i]
        docs = [np.asarray(corpus.doc_tokens[d], np.int64) for d in r.docs]
        prompt = np.concatenate(docs + [np.asarray(
            due[i].question_tokens, np.int64)])
        out.append({"req_id": i, "kind": kinds[i], "prompt": prompt,
                    "served": np.asarray(r.tokens, np.int64),
                    "first_logits": np.asarray(r.first_logits, np.float32)})
    return out


def readings(config: Dict, params, sample: List[Dict], *,
             fp8: bool = False, ref_logits=None) -> Tuple[Dict, list]:
    """The two numbers for the program's tokens (``fp8=False``), or for the
    control's (``fp8=True``, read against ``ref_logits``, the float32
    reference's); and the float32 logits it computed."""
    import torch
    from ragbench.reference import Reference
    dev = params["embed"].device
    seqs, first = [], []
    for s in sample:
        full = np.concatenate([s["prompt"], s["served"][:-1]])
        seqs.append(torch.from_numpy(full).to(dev))
        first.append(len(s["prompt"]) - 1)
    logits = [x.cpu().numpy() for x in Reference(
        config, params, fp8=fp8).logits(seqs, first)]
    ref = logits if ref_logits is None else ref_logits
    gap = err = 0.0
    for s, lg, rf in zip(sample, logits, ref):
        toks = s["served"] if not fp8 else lg.argmax(-1)
        best = rf.max(-1)
        gap = max(gap, float((best - rf[np.arange(len(toks)), toks]).max()))
        mine = lg[0] if fp8 else s["first_logits"]
        err = max(err, float(np.abs(mine - rf[0]).max()))
    return {"token_gap": gap, "first_logit_err": err}, logits


def compare(config: Dict, params, sample: List[Dict], spec: Dict, *,
            control: bool = False) -> Tuple[Dict, Optional[Dict], Dict]:
    """{name: {"value", "limit"}} of the program's numbers, the control's
    numbers when asked for, and what the sample held."""
    limits = spec["limits"]
    info = {"kinds": {k: sum(1 for s in sample if s["kind"] == k)
                      for k in ("gpu", "host", "none")},
            "tokens": int(sum(len(s["served"]) for s in sample))}
    if not sample:
        return {n: {"value": float("inf"), "limit": lim}
                for n, lim in limits.items()}, None, info
    mine, ref = readings(config, params, sample)
    checks = {n: {"value": mine[n], "limit": limits[n]} for n in limits}
    ctl = None
    if control:
        ctl, _ = readings(config, params, sample, fp8=True, ref_logits=ref)
    return checks, ctl, info


def correct(checks: Dict) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())
