"""Share (%) of the prompt tokens of the requests that got their first
token in the window that came from the knowledge tree (GPU, host and disk
tiers), by the final prefill's plan (``RequestTimeline.hit_tokens_*``).
Layer: knowledge tree."""


def read(run):
    done = [r for r in run.requests
            if r.first is not None and r.first <= run.close]
    prompt = sum(r.prompt_tokens for r in done)
    return 100.0 * sum(sum(r.hit_tokens) for r in done) / prompt \
        if prompt else None
