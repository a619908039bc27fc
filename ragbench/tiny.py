"""Tiny stand-ins for a configuration, a traffic file and a cell, for the
CPU tests: the reduced Mistral-7B and Mixtral-8x7B of the port (2 layers,
d 256, a 64-token window; Mixtral with 4 experts), in float32."""
from __future__ import annotations

import copy

REDUCED = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
               vocab_size=512, sliding_window=64, rope_theta=10000.0,
               dtype="float32")

ENGINE = {"max_batch": 4, "max_prefill_bs": 4, "max_prefill_tokens": 256,
          "prefill_chunk": 0, "block_size": 16, "policy": "pgdsf",
          "reorder": True, "speculative": True, "pool_margin_bytes": 0,
          "reserve_blocks": 64, "host_cache_bytes": 1 << 20,
          "n_blocks": 320}

TRAFFIC = {"base_seed": 5, "n_docs": 60, "doc_tokens_median": 40,
           "embed_dim": 32, "ivf_clusters": 8, "nprobe": 4, "top_k": 2,
           "question_tokens": 8, "max_new_tokens": 4, "zipf_s": 1.0,
           "query_noise": 0.05}

CELL = {"config": "tiny", "traffic": "tiny", "rate": 12.0,
        "ttft_limit_ms": 5000, "tpot_limit_ms": 5000, "warmup_batch": 8,
        "warmup_max": 16, "profile_seconds": 0.3,
        "check": {"sample": 4, "per_kind": 1,
                  "limits": {"token_gap": 1e-3, "first_logit_err": 1e-3}}}


def config(moe: bool = False) -> dict:
    c = {"name": "tiny-moe" if moe else "tiny", "hidden_size": 256,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 512,
         "vocab_size": 512, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
         "sliding_window": 64,
         "port": {"config": "mixtral-8x7b" if moe else "mistral-7b",
                  "replace": dict(REDUCED)},
         "engine": dict(ENGINE)}
    if moe:
        c.update(num_local_experts=4, num_experts_per_tok=2)
        c["port"]["replace"]["moe_experts"] = 4
    return c


def cell() -> dict:
    return copy.deepcopy(CELL)
