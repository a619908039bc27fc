"""The port's model configs equal the JAX package's, field by field."""
import dataclasses

import pytest
import torch

torch.set_num_threads(2)

from repro import configs as jax_configs
from repro_torch import configs as torch_configs


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
def test_qwen2_config_fields_match(getter):
    a = getattr(jax_configs, getter)("qwen2-0.5b")
    b = getattr(torch_configs, getter)("qwen2-0.5b")
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa == fb
    assert a.layer_windows() == b.layer_windows()
    assert (a.hd, a.q_rep, a.n_params()) == (b.hd, b.q_rep, b.n_params())
    assert b.tdtype == torch.bfloat16
    assert dataclasses.replace(b, dtype="float32").tdtype == torch.float32


def test_unported_architecture_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_configs.get_config("gemma2-27b")
