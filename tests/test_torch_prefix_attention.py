"""The port's prefix-attention plain version, its dense oracle and
``layers.flash_attention`` against the JAX package's on identical inputs
(made with numpy from a seed).

Covered: GQA R in {1, 2, 7}; head dims 32 and 64; prefix 0 and > 0; Sq
and Skv not multiples of the 128 block; window 0 and 24; a logit cap of 30
(against the JAX oracle only: the Pallas kernel has no cap); Sq 1.
Tolerances: f32 max abs <= 1e-5 (summation order only); bf16 compared in
f32, max abs <= 2e-2 (a few bf16 ulps of outputs below ~2).  The CUDA
kernel itself runs only on the card (chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.kernels import prefix_attention as jax_pa
from repro.kernels import ref as jax_ref
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels import prefix_attention as PA
from repro_torch.kernels import ref
from repro_torch.models import layers as L

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def inputs(seed, R, prefix, Sq, hd, B=1, KV=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, R * KV, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, prefix + Sq, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, prefix + Sq, hd)).astype(np.float32)
    return q, k, v


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _close(a_torch, b_jax, dtype):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err <= TOL[dtype], err


# (prefix, Sq, hd, window): one query block, several key blocks with a
# ragged last one, a window cutting through the prefix, a single query
CASES = [(0, 40, 32, 0), (150, 37, 64, 0), (150, 37, 64, 24), (200, 1, 64, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 2, 7])
@pytest.mark.parametrize("prefix,Sq,hd,window", CASES)
def test_plain_and_oracle_match_jax(dtype, R, prefix, Sq, hd, window):
    ins = inputs(R + prefix + Sq, R, prefix, Sq, hd)
    want = jax_ref.reference_prefix_attention(*_jax(ins, dtype),
                                              prefix_len=prefix,
                                              window=window)
    tt = _torch(ins, dtype)
    got = ops.prefix_attention(*tt, prefix_len=prefix, window=window)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    _close(ref.reference_prefix_attention(*tt, prefix_len=prefix,
                                          window=window), want, dtype)


@pytest.mark.parametrize("R,prefix,Sq,hd,window", [
    (7, 150, 37, 64, 0), (2, 0, 40, 32, 24), (1, 130, 3, 64, 0)])
def test_plain_matches_pallas_interpret(R, prefix, Sq, hd, window):
    """Against the Pallas kernel body itself (interpret mode, 64-blocks)."""
    ins = inputs(R + 2 * prefix + Sq, R, prefix, Sq, hd)
    want = jax_pa.prefix_flash_attention(
        *_jax(ins, jnp.float32), prefix_len=prefix, window=window,
        block_q=64, block_k=64, interpret=True)
    got = PA.prefix_attention_torch(*_torch(ins, "float32"),
                                    prefix_len=prefix, window=window)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 24])
def test_logit_cap_matches_jax_oracle(dtype, window):
    q, k, v = inputs(9, 7, 150, 37, 64)
    ins = (8.0 * q, k, v)                       # scores past the cap
    want = jax_ref.reference_prefix_attention(
        *_jax(ins, dtype), prefix_len=150, window=window, logit_cap=30.0)
    tt = _torch(ins, dtype)
    _close(PA.prefix_attention_torch(*tt, prefix_len=150, window=window,
                                     logit_cap=30.0), want, dtype)
    _close(ref.reference_prefix_attention(*tt, prefix_len=150,
                                          window=window, logit_cap=30.0),
           want, dtype)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 30.0)])
def test_layers_flash_attention_matches_jax(window, cap):
    """The model-layout entry point against the JAX package's
    ``layers.flash_attention`` on (B, S, heads, hd) inputs."""
    rng = np.random.default_rng(11)
    B, Sq, P, H, KV, hd = 2, 37, 150, 14, 2, 64
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, P + Sq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, P + Sq, KV, hd)).astype(np.float32)
    want = JL.flash_attention(*_jax((q, k, v), jnp.float32), q_offset=P,
                              window=window, logit_cap=cap)
    got = L.flash_attention(*_torch((q, k, v), "float32"), q_offset=P,
                            window=window, logit_cap=cap)
    assert got.shape == (B, Sq, H, hd)
    _close(got, want, "float32")


def test_mismatched_lengths_raise():
    q, k, v = _torch(inputs(1, 2, 10, 5, 32), "float32")
    with pytest.raises(ValueError, match="prefix_len"):
        PA.prefix_attention_torch(q, k, v, prefix_len=9)


def test_cuda_impl_on_cpu_tensors_raises():
    q, k, v = _torch(inputs(2, 2, 10, 5, 32), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.prefix_attention(q, k, v, prefix_len=10, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.prefix_attention(q, k, v, prefix_len=10, impl="pallas")


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    q, k, v = _torch(inputs(3, 7, 20, 9, 64), "float32")
    launches, calls = (PA.prefix_flash_attention.launches,
                       PA.prefix_attention_torch.calls)
    out = PA.prefix_flash_attention(q, k, v, prefix_len=20)
    assert PA.prefix_flash_attention.launches == launches
    assert PA.prefix_attention_torch.calls == calls + 1
    assert torch.equal(out, PA.prefix_attention_torch(q, k, v,
                                                      prefix_len=20))
