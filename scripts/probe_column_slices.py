"""Probe, on one CUDA card, whether a column slice of a product keeps its
bits: ``x @ w[:, shard]`` (the shard a contiguous copy) against the same
columns of ``x @ w``, for Qwen2-0.5B's and Mistral-7B's column products
(wq, wk, the gate/up width and the logits) at tp 2 and 4, and Mixtral-
8x7B's router (8 columns) at tp 2, 4 and 8, bf16 and f32 (no TF32), 1 to
2048 rows.  Each product of the whole weight runs through
``layers.proj``; a shard's through the whole weight's row rule.  Then the
batched expert products of ``layers.moe_capacity`` at Mixtral's widths
(``eCd,edf->eCf``, 8 experts, buffers of 16 to 1280 rows): each group of
8 / tp experts as one call against the same experts' slice of one call
over all 8.  Prints one ``DIFF`` line per differing (dtype, model,
product, width, tp, rows) with the largest difference, then the count.

    python3 scripts/probe_column_slices.py      # from the repository root
"""

import sys

sys.path.insert(0, "src")
import torch  # noqa: E402

from repro_torch.models import layers as L  # noqa: E402

MODELS = {
    "qwen": dict(D=896, wq=896, wk=128, wg=4864, lm=151936, tied=True),
    "mistral": dict(D=4096, wq=4096, wk=1024, wg=14336, lm=32000, tied=False),
    "mixtral": dict(D=4096, router=8, tied=False),
}
EXPERTS = dict(E=8, D=4096, F=14336)
EXPERT_ROWS = (16, 80, 320, 640, 1280)
ROWS = (1, 2, 3, 4, 7, 8, 16, 32, 64, 128, 200, 256, 512, 1024, 2048)


def products(c, name, dt, g):
    """(whole product, shards of tp, one shard's product) for ``name``."""
    D, N = c["D"], c[name]
    if c["tied"] and name == "lm":
        W = (torch.randn(N, D, generator=g, device="cuda") * 0.02).to(dt)
        return (
            lambda x: torch.matmul(x, W.t()).float(),
            lambda tp: [w.contiguous() for w in W.chunk(tp, 0)],
            lambda x, w: torch.matmul(x, w.t()).float(),
        )
    W = (torch.randn(D, N, generator=g, device="cuda") * 0.02).to(dt)

    def shard(x, w):
        if L.slabbed(W):
            return L.row_slabs(lambda r: L.dense(r, w), x).float()
        return L.dense(x, w).float()

    return (
        lambda x: L.proj(x, W).float(),
        lambda tp: [w.contiguous() for w in W.chunk(tp, 1)],
        shard,
    )


def expert_groups(dt, g):
    """The batched expert products in groups of E / tp experts against one
    call over all E: the DIFF tuples."""
    E, D, F = EXPERTS["E"], EXPERTS["D"], EXPERTS["F"]
    w = (torch.randn(E, D, F, generator=g, device="cuda") * 0.02).to(dt)
    bad = []
    for rows in EXPERT_ROWS:
        x = torch.randn(E, rows, D, generator=g, device="cuda").to(dt)
        want = torch.einsum("eCd,edf->eCf", x, w).float()
        for tp in (2, 4, 8):
            n = E // tp
            got = torch.cat([torch.einsum("eCd,edf->eCf",
                                          x[j * n:(j + 1) * n].contiguous(),
                                          w[j * n:(j + 1) * n].contiguous())
                             for j in range(tp)]).float()
            if not torch.equal(got, want):
                d = (got - want).abs().max().item()
                bad.append((str(dt), "mixtral", "experts", F, tp, rows, d))
    del w
    torch.cuda.empty_cache()
    return bad


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for dt in (torch.bfloat16, torch.float32):
        for m, c in MODELS.items():
            for name in (n for n in ("wq", "wk", "wg", "lm", "router") if n in c):
                whole, shards, shard = products(c, name, dt, g)
                for tp in (2, 4, 8) if name == "router" else (2, 4):
                    if c[name] % tp:
                        continue
                    parts = shards(tp)
                    for rows in ROWS:
                        if dt == torch.float32 and rows > 512:
                            continue
                        x = torch.randn(rows, c["D"], generator=g, device="cuda")
                        x = x.to(dt)
                        want = whole(x)
                        got = torch.cat([shard(x, w) for w in parts], dim=-1)
                        if not torch.equal(got, want):
                            d = (got - want).abs().max().item()
                            bad.append((str(dt), m, name, c[name], tp, rows, d))
                torch.cuda.empty_cache()
        bad += expert_groups(dt, g)
    for b in bad:
        print("DIFF", b)
    print("differing:", len(bad))


if __name__ == "__main__":
    main()
