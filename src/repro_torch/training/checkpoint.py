"""Flat-npz checkpoints of the port's nested param dicts (counterpart of
``repro.training.checkpoint``), in the reference's format: one array a
leaf under its ``/``-joined path (``"blocks/wq"``), bf16 stored as f32, and
the step under ``__step__``.  Either framework reads the other's files.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from repro_torch.models.model import params_to_numpy


def save(path: str, tree, step: int = 0) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, __step__=np.asarray(step), **params_to_numpy(tree))


def restore(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shapes must match); each
    leaf takes the dtype and device of ``like``'s."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")

    def load(node, prefix):
        if isinstance(node, Mapping):
            return {k: load(v, prefix + k + "/") for k, v in node.items()}
        key = prefix[:-1]
        arr = data[key]
        assert arr.shape == tuple(node.shape), (key, arr.shape, node.shape)
        return torch.from_numpy(np.array(arr)).to(device=node.device,
                                                  dtype=node.dtype)

    return load(like, ""), int(data["__step__"])
