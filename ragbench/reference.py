"""Plain float32 reference of the benchmark's decoders (Mistral-7B and
Mixtral-8x7B as their published ``config.json`` describes them).

RMSNorm, rotary embeddings (rotate-half), grouped-query attention with the
sliding window where the config has one, SwiGLU, and top-k softmax routing
over the experts.  Plain PyTorch on the benchmark's own weights (the port's
parameter layout, see weights.py): it imports nothing of the program.  One
layer's weights are cast to float32 at a time, so it fits beside the weights
on the card; attention runs in blocks of queries.  TF32 is switched off.

``fp8=True`` is the control: every projection's weight (per output column)
and input (per row) rounded through float8 e4m3 with its own scale, the
products then taken in float32 -- the precision below the bf16 the
configurations are served in.

Departures from the published models: the norms' learned scale is stored as
an offset (the port's layout multiplies by 1 + offset), and the weights are
seeded random ones.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Dims:
    def __init__(self, c: Dict):
        self.D = c["hidden_size"]
        self.L = c["num_hidden_layers"]
        self.H = c["num_attention_heads"]
        self.KV = c["num_key_value_heads"]
        self.hd = c.get("head_dim") or self.D // self.H
        self.F = c["intermediate_size"]
        self.V = c["vocab_size"]
        self.eps = c["rms_norm_eps"]
        self.theta = c["rope_theta"]
        self.window = c.get("sliding_window") or 0
        self.E = c.get("num_local_experts", 0)
        self.top_k = c.get("num_experts_per_tok", 0)


class Reference:
    def __init__(self, config: Dict, params: Dict, *, fp8: bool = False,
                 q_block: int = 512):
        self.d = Dims(config)
        self.p = params
        self.fp8 = fp8
        self.q_block = q_block

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return fp8_round(x, -1) @ fp8_round(w, 0)
        return x @ w

    def norm(self, x, w):
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                + self.d.eps)) * (1.0 + w.float())

    def rope(self, x, pos):
        hd = x.shape[-1]
        inv = self.d.theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                             device=x.device) / hd)
        ang = pos[:, None].double() * inv[None]
        cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attend(self, q, k, v):
        """q (S, H, hd), k/v (S, KV, hd) -> (S, H * hd), causal, windowed."""
        d = self.d
        S, R = q.shape[0], d.H // d.KV
        k = k.repeat_interleave(R, dim=1)
        v = v.repeat_interleave(R, dim=1)
        out = torch.empty((S, d.H, d.hd), dtype=torch.float32,
                          device=q.device)
        for a in range(0, S, self.q_block):
            b = min(S, a + self.q_block)
            lo = max(0, a - d.window + 1) if d.window else 0
            qp = torch.arange(a, b, device=q.device)[:, None]
            kp = torch.arange(lo, b, device=q.device)[None]
            mask = kp <= qp
            if d.window:
                mask &= kp > qp - d.window
            s = torch.einsum("qhd,khd->hqk", q[a:b], k[lo:b]) * d.hd ** -0.5
            s = s.masked_fill(~mask[None], float("-inf"))
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                    v[lo:b])
        return out.reshape(S, d.H * d.hd)

    def ffn(self, h, blk, li):
        d = self.d
        if not d.E:
            g = self.mm(h, blk["wg"][li].float())
            u = self.mm(h, blk["wu"][li].float())
            return self.mm(torch.nn.functional.silu(g) * u,
                           blk["wd"][li].float())
        logits = self.mm(h, blk["router"][li].float())
        top, idx = torch.topk(logits, d.top_k, dim=-1)
        gates = torch.softmax(top, dim=-1)
        out = torch.zeros_like(h)
        for e in range(d.E):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            x = h[rows]
            y = torch.nn.functional.silu(self.mm(x, blk["wg"][li, e].float())) \
                * self.mm(x, blk["wu"][li, e].float())
            y = self.mm(y, blk["wd"][li, e].float())
            out.index_add_(0, rows, y * gates[rows, slot][:, None])
        return out

    def logits(self, seqs: Sequence[torch.Tensor],
               first: Sequence[int]) -> List[torch.Tensor]:
        """f32 logits (S_i - first[i], V) at positions first[i] .. S_i - 1
        of each token sequence (1-D int64 on the device)."""
        d, blk = self.d, self.p["blocks"]
        with exact_f32(), torch.no_grad():
            xs = [self.p["embed"][s].float() for s in seqs]
            for li in range(d.L):
                w = {n: blk[n][li].float() for n in ("wq", "wk", "wv", "wo")}
                for i, x in enumerate(xs):
                    S = x.shape[0]
                    pos = torch.arange(S, device=x.device)
                    h = self.norm(x, blk["ln1"][li])
                    q = self.rope(self.mm(h, w["wq"]).view(S, d.H, d.hd), pos)
                    k = self.rope(self.mm(h, w["wk"]).view(S, d.KV, d.hd), pos)
                    v = self.mm(h, w["wv"]).view(S, d.KV, d.hd)
                    x = x + self.mm(self.attend(q, k, v), w["wo"])
                    xs[i] = x + self.ffn(self.norm(x, blk["ln2"][li]), blk, li)
                del w
            head = self.p["lm_head"].float()
            out = [self.mm(self.norm(x[f:], self.p["final_norm"]), head)
                   for x, f in zip(xs, first)]
        return out
