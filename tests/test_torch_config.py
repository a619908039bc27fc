"""The port's model configs equal the JAX package's, field by field."""
import dataclasses

import pytest
import torch

torch.set_num_threads(2)

from repro import configs as jax_configs
from repro_torch import configs as torch_configs

ARCHS = ["qwen2-0.5b", "mistral-7b", "llama2-7b", "gemma3-12b",
         "gemma2-27b", "yi-34b", "llama2-70b", "mixtral-8x7b",
         "phi3.5-moe-42b-a6.6b", "internvl2-1b", "xlstm-1.3b", "hymba-1.5b",
         "musicgen-large"]
# K and V bytes a token, bf16, all layers (the config modules' docstrings:
# 0.125 MiB for Mistral-7B, 0.5 MiB for LLaMA2-7B, 0.3125 MiB for
# LLaMA2-70B)
KV_BYTES = {"mistral-7b": 131_072, "llama2-7b": 524_288,
            "llama2-70b": 327_680}


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match(arch, getter):
    a = getattr(jax_configs, getter)(arch)
    b = getattr(torch_configs, getter)(arch)
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa == fb
    assert a.layer_windows() == b.layer_windows()
    assert (a.hd, a.q_rep, a.n_params()) == (b.hd, b.q_rep, b.n_params())
    assert b.tdtype == torch.bfloat16
    assert dataclasses.replace(b, dtype="float32").tdtype == torch.float32
    if getter == "get_config" and arch in KV_BYTES:
        kv = 2 * b.n_layers * b.n_kv_heads * b.hd * b.tdtype.itemsize
        assert kv == KV_BYTES[arch]


def test_registry_lists_the_served_models():
    assert torch_configs.list_configs() == [
        "qwen2_0p5b", "mistral_7b", "llama2_7b", "gemma3_12b", "gemma2_27b",
        "yi_34b", "llama2_70b", "mixtral_8x7b", "phi35_moe_42b",
        "internvl2_1b", "xlstm_1p3b", "hymba_1p5b", "musicgen_large"]
    assert torch_configs.get_config("mistral-7b").layer_windows() == \
        (4096,) * 32
    assert torch_configs.get_reduced("mistral-7b").layer_windows() == \
        (64,) * 2
    assert torch_configs.get_config("llama2-7b").q_rep == 1
    mixtral = torch_configs.get_config("mixtral-8x7b")
    assert (mixtral.family, mixtral.moe_experts, mixtral.moe_top_k) == \
        ("moe", 8, 2)
    assert mixtral.layer_windows() == (4096,) * 32
    assert torch_configs.get_config("phi3.5-moe-42b-a6.6b").moe_experts == 16
    assert torch_configs.get_config("internvl2-1b").family == "vlm"
    gemma3 = torch_configs.get_config("gemma3-12b")
    assert (gemma3.hd, gemma3.q_rep, gemma3.vocab_size) == (256, 2, 262144)
    assert gemma3.layer_windows() == ((1024,) * 5 + (0,)) * 8
    gemma2 = torch_configs.get_config("gemma2-27b")
    assert (gemma2.attn_logit_softcap, gemma2.final_logit_softcap) == \
        (50.0, 30.0)
    assert gemma2.layer_windows() == (4096, 0) * 23
    assert torch_configs.get_config("yi-34b").q_rep == 7
    assert torch_configs.get_config("llama2-70b").q_rep == 8


def test_unported_architecture_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_configs.get_config("deepseek-v3")


# the published widths of the recurrent and audio models (their config
# modules' docstrings and papers): layers, d_model, heads / KV heads, d_ff,
# vocabulary, and the family's own fields
PUBLISHED = {
    "xlstm-1.3b": dict(family="ssm", n_layers=48, d_model=2048, n_heads=4,
                       n_kv_heads=4, d_ff=0, vocab_size=50304,
                       slstm_every=8, proj_factor=2.0, conv_kernel=4),
    "hymba-1.5b": dict(family="hybrid", n_layers=32, d_model=1600,
                       n_heads=25, n_kv_heads=5, d_ff=5504,
                       vocab_size=32001, ssm_state=16, sliding_window=1024,
                       global_every=16),
    "musicgen-large": dict(family="audio", n_layers=48, d_model=2048,
                           n_heads=32, n_kv_heads=32, d_ff=8192,
                           vocab_size=2048, n_codebooks=4,
                           tie_embeddings=False),
}


@pytest.mark.parametrize("arch", sorted(PUBLISHED))
def test_published_widths_of_the_recurrent_and_audio_models(arch):
    a, b = jax_configs.get_config(arch), torch_configs.get_config(arch)
    for field, want in PUBLISHED[arch].items():
        assert getattr(a, field) == getattr(b, field) == want, field
    assert a.hd == b.hd == (64 if arch != "xlstm-1.3b" else 512)
    if arch == "hymba-1.5b":
        # R 5, the first odd head ratio the prefix kernel serves; two
        # global layers (15 and 31) among windows of 1024
        assert b.q_rep == 5
        assert [i for i, w in enumerate(b.layer_windows()) if w == 0] == \
            [15, 31]
