"""Probe, on one CUDA card, the row invariance of every column-slab shape
the served models' products take: for each model of the registry, the
(K, N / G) shape of its q, k/v, gate/up and logits slabs, G the largest of
4, 2, 1 dividing both head counts (the column-slab group of its widest
tensor-parallel mesh up to 4, launch/mesh.py), and of the whole o and
down products: row 0 of a call of 1 to 8192 bf16 rows
against row 0 of a one-row call, in one call (``plain``) and through
``layers.row_slabs`` (``row slabs``), beside what ``layers.slabbed``
decides for the shape.  Tied logits run as ``x @ e.T``.  Random N(0, 0.02)
weights, N(0, 1) inputs; shapes seen once are not probed again.

    python3 scripts/probe_slab_rows.py          # from the repository root
"""

import sys

sys.path.insert(0, "src")
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ROWS = (1, 8, 64, 128, 512, 2048, 8192)
ARCHS = (
    "qwen2-0.5b",
    "mistral-7b",
    "llama2-7b",
    "gemma3-12b",
    "gemma2-27b",
    "yi-34b",
    "mixtral-8x7b",
    "internvl2-1b",
    "llama2-70b",
    "phi3.5-moe-42b-a6.6b",
    "hymba-1.5b",
)


def variant(fn, x):
    """Row 0's largest difference at each row count from a one-row call."""
    ref0 = fn(x[:1])[0].float()
    return {m: (fn(x[:m])[0].float() - ref0).abs().max().item() for m in ROWS}


def shapes(cfg):
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = next(t for t in (4, 2, 1) if H % t == 0 and KV % t == 0)
    out = [("q", D, H * hd // s), ("kv", D, KV * hd // s), ("o", H * hd, D)]
    if not cfg.moe_experts:
        out += [("gu", D, F // s), ("d", F, D)]
    return out + [("logits_tied" if cfg.tie_embeddings else "logits", D, V // s)]


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    seen = {}
    for arch in ARCHS:
        for name, K, N in shapes(get_config(arch)):
            tied = name == "logits_tied"
            if (K, N, tied) in seen:
                print(arch, name, (K, N), "same as", seen[K, N, tied])
                continue
            seen[K, N, tied] = arch
            x = torch.randn(max(ROWS), K, generator=g, device="cuda")
            x = x.to(torch.bfloat16)
            shape = (N, K) if tied else (K, N)
            w = torch.randn(shape, generator=g, device="cuda") * 0.02
            w = w.to(torch.bfloat16)

            def prod(t, w=w, tied=tied):
                return torch.matmul(t, w.t()) if tied else L.dense(t, w)

            a = variant(prod, x)
            b = variant(lambda t: L.row_slabs(prod, t), x)
            va = any(v != 0 for v in a.values())
            vb = any(v != 0 for v in b.values())
            rule = L.slabbed(torch.empty(K, N, device="meta"))
            print(
                f"{arch} {name} K={K} N={N}: plain variant {va} "
                f"{a if va else ''}; row slabs variant {vb}; rule slabs {rule}",
                flush=True,
            )
            del w, x
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
