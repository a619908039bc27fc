"""The port's model configs equal the JAX package's, field by field."""
import dataclasses

import pytest
import torch

torch.set_num_threads(2)

from repro import configs as jax_configs
from repro_torch import configs as torch_configs

ARCHS = ["qwen2-0.5b", "mistral-7b", "llama2-7b", "mixtral-8x7b",
         "phi3.5-moe-42b-a6.6b", "internvl2-1b"]
# K and V bytes a token, bf16, all layers (the config modules' docstrings:
# 0.125 MiB for Mistral-7B, 0.5 MiB for LLaMA2-7B)
KV_BYTES = {"mistral-7b": 131_072, "llama2-7b": 524_288}


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
        "qwen2_0p5b", "mistral_7b", "llama2_7b", "mixtral_8x7b",
        "phi35_moe_42b", "internvl2_1b"]
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


def test_unported_architecture_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_configs.get_config("gemma2-27b")
