"""Architecture registry of the port (counterpart of ``repro.configs``).

``get_config(arch_id)`` returns the full published config;
``get_reduced(arch_id)`` the CPU-test variant of the same family.  Only the
dense models the port serves are registered: Qwen2-0.5B, and the paper's
two evaluation models, Mistral-7B (GQA, a 4096-token sliding window on
every layer) and LLaMA2-7B (MHA).  The other architectures join with their
model code (ROADMAP.md, Queue A).
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
]

_ALIASES = {
    "qwen2-0.5b": "qwen2_0p5b",
    "mistral-7b": "mistral_7b",
    "llama2-7b": "llama2_7b",
}


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
