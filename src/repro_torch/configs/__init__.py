"""Architecture registry of the port (counterpart of ``repro.configs``).

``get_config(arch_id)`` returns the full published config;
``get_reduced(arch_id)`` the CPU-test variant of the same family.  Every
architecture of the JAX package is registered: Qwen2-0.5B; the paper's two
evaluation models, Mistral-7B (GQA, a 4096-token sliding window on every
layer) and LLaMA2-7B (MHA); the rest of the dense family, Gemma3-12B (head
dim 256, a 1024 window on 5 of every 6 layers), Gemma2-27B (a 4096 window
on every other layer, softcaps 50 and 30), Yi-34B (R 7) and LLaMA2-70B
(138 GB of bf16 weights: at full size it needs ``--tp 4``, whose first
card holds 70.7 GB and at most 72.6 GB while the weights are drawn); the
MoE family, Mixtral-8x7B (8 experts, top
2, the paper's large-model target) and Phi-3.5-MoE (16 experts, top 2);
the VLM family's InternVL2-1B, whose text backbone the runtimes serve; the
recurrent families, xLSTM-1.3B (ssm) and Hymba-1.5B (hybrid), which the
sequential engine serves; and the audio family's MusicGen-large, which runs
through the model steps only.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_ARCHS = [
    "qwen2_0p5b",
    # paper's own evaluation models
    "mistral_7b",
    "llama2_7b",
    # the rest of the dense family
    "gemma3_12b",
    "gemma2_27b",
    "yi_34b",
    "llama2_70b",
    # mixture of experts
    "mixtral_8x7b",
    "phi35_moe_42b",
    # vision-language backbone
    "internvl2_1b",
    # recurrent state: xLSTM (ssm) and Hymba (hybrid)
    "xlstm_1p3b",
    "hymba_1p5b",
    # audio codebooks
    "musicgen_large",
]

_ALIASES = {
    "qwen2-0.5b": "qwen2_0p5b",
    "mistral-7b": "mistral_7b",
    "llama2-7b": "llama2_7b",
    "gemma3-12b": "gemma3_12b",
    "gemma2-27b": "gemma2_27b",
    "yi-34b": "yi_34b",
    "llama2-70b": "llama2_70b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-1.3b": "xlstm_1p3b",
    "hymba-1.5b": "hymba_1p5b",
    "musicgen-large": "musicgen_large",
}


# the architectures the compile analysis sweeps (launch/dryrun.py --all)
ASSIGNED = [
    "xlstm-1.3b", "hymba-1.5b", "phi3.5-moe-42b-a6.6b", "yi-34b",
    "gemma3-12b", "internvl2-1b", "musicgen-large", "gemma2-27b",
    "mixtral-8x7b", "qwen2-0.5b",
]


def _module(name: str):
    mod = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod not in _ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP.md Queue A); "
            f"ported: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def list_configs() -> List[str]:
    return list(_ARCHS)
