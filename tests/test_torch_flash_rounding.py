"""What a bf16 flash-attention kernel can be held to where outputs are large.

The TPU kernel (``repro.kernels.flash_attention``, run here in interpret
mode) computes in f32 from its bf16 inputs and rounds once, at the output.
So it lies within one bf16 step of the f32 attention of the same inputs,
``max(2e-2, 2^(floor(log2|o32|) - 7))`` at each element, and that is the
bound the card's kernel is held to
(``tests/test_torch_cuda.py::test_flash_bf16_rounding_margin_at_large_outputs``,
the same inputs).  The plain versions (``repro.kernels.ref.mha_reference``
and the port's copy) round the normalised probabilities to bf16 before P V,
and end up to one step away on their own side: once a step exceeds 4e-2
(|o| >= 16) the TPU kernel itself misses an absolute 2e-2 against them,
which is why the card's check could not keep that form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention
from repro_torch.kernels import ref

TOL_BF16 = 2e-2


def _inputs(hd):
    """tests/test_torch_cuda.py's (``ref.large_output_inputs``), as JAX arrays."""
    return [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
            for x in ref.large_output_inputs(hd, "cpu")]


def _one_step(o32):
    """``ref.bf16_step``: one bf16 step of each exact output, at least 2e-2."""
    return ref.bf16_step(torch.from_numpy(np.array(o32)), TOL_BF16).numpy()


@pytest.mark.parametrize("hd", [64, 256])
def test_tpu_kernel_rounds_once_and_misses_the_plain_version(hd):
    q, k, v = _inputs(hd)
    out = np.asarray(flash_attention(q, k, v, causal=True, interpret=True), np.float32)
    f32 = [x.astype(jnp.float32) for x in (q, k, v)]
    o32 = np.asarray(jref.mha_reference(*f32, causal=True))
    plain = np.asarray(jref.mha_reference(q, k, v, causal=True), np.float32)
    assert np.abs(o32).max() >= 16.0
    # within one bf16 step of the exact output everywhere, half a step where
    # it is large: the kernel's f32 result rounded once
    err = np.abs(out - o32)
    assert np.all(err <= _one_step(o32))
    large = np.abs(o32) >= 16.0
    assert err[large].max() <= 0.0625 + 1e-3
    # and an absolute 2e-2 against the plain version, which rounds its
    # probabilities to bf16, does not hold: one step in [16, 32) apart
    assert np.abs(out - plain).max() >= 0.125
    # the port's plain version computes what the JAX oracle computes
    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    port_plain = ref.mha_reference(to_t(q), to_t(k), to_t(v), causal=True).float().numpy()
    port_o32 = ref.mha_reference(*(to_t(x).float() for x in (q, k, v)), causal=True).numpy()
    assert np.abs(port_o32 - o32).max() < 1e-4
    assert np.abs(port_plain - plain).max() <= 0.125
