"""What a bf16 decode-attention kernel can be held to where outputs are large.

The TPU decode kernel (``repro.kernels.decode_attention``, run here in
interpret mode) keeps the probabilities in f32, multiplies them into V in
f32 and rounds once, at the output.  So on bf16 inputs it lies within half
a bf16 step of the f32 attention ``o32`` of the same inputs, and within one
step ``max(2e-2, 2^(floor(log2|o32|) - 7))`` everywhere: the bound the
card's kernel is held to
(``tests/test_torch_cuda.py::test_decode_bf16_rounding_margin_at_large_outputs``
and ``chip_smoke.py`` phase 2, the same inputs).  The plain versions round
the probabilities to bf16 before P V and miss that bound on their own side.

The card's kernel multiplies V by unnormalised P on the tensor cores,
64 slots (one tile) at a time.  Rounding that P to bf16 misses one step
over ``ref.DECODE_ROUNDING_SEEDS``; P as a bf16 high and low part, as
``csrc/decode_attention.cu`` multiplies it, stays within half a step.  The
last test shows both on the CPU with the kernel's per-tile arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention
from repro_torch.kernels import ref


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("hd", [64, 256])
def test_tpu_decode_kernel_rounds_once(hd):
    q, k, v, valid = ref.large_output_decode_inputs(hd, "cpu")
    assert q.shape[1] // k.shape[2] == (16 if hd == 256 else 4)
    qj, kj, vj, vl = _jax(q), _jax(k), _jax(v), jnp.asarray(valid.numpy())
    out = np.asarray(decode_attention(qj, kj, vj, vl, interpret=True),
                     np.float32)
    f32 = [x.astype(jnp.float32) for x in (qj, kj, vj)]
    o32 = np.asarray(jref.decode_attention_reference(*f32, vl))
    assert np.abs(o32).max() >= 16.0
    # half a bf16 step of o32 everywhere (the f32 result rounded once; the
    # 1e-3 is the f32 sums' own order), so one step holds with room
    step = ref.bf16_step(torch.from_numpy(o32.copy())).numpy()
    err = np.abs(out - o32)
    assert np.all(err <= (0.5 + 1e-3) * step)
    # the port's measure gives the same, from the port's own f32 oracle
    steps = ref.bf16_steps_from_f32(torch.from_numpy(out), q, k, v,
                                    valid=valid)
    assert float(steps.max()) <= 0.5 + 1e-3
    # the plain version rounds its probabilities to bf16 and misses one step
    plain = np.asarray(jref.decode_attention_reference(qj, kj, vj, vl),
                       np.float32)
    assert (np.abs(plain - o32) / step).max() > 1.0
    port_plain = ref.decode_attention_reference(q, k, v, valid).float().numpy()
    assert np.abs(port_plain - plain).max() <= 0.125


def _subtile_decode(q, k, v, valid, *, hi_lo: bool):
    """The bf16 tensor-core path of ``csrc/decode_attention.cu`` in f32 on
    the CPU, on one rank's slots: an online softmax over 64-slot tiles,
    unnormalised P rounded to bf16 (or split into a bf16 high and low part)
    before it multiplies V, the sum l of P in f32, o / l rounded once to
    bf16."""
    b, nq, hd = q.shape
    nkv = k.shape[2]
    s = torch.einsum("bkgh,bskh->bkgs", q.float().reshape(b, nkv, nq // nkv, hd),
                     k.float()) * (hd ** -0.5 * 1.4426950408889634)
    s = torch.where(valid[:, None, None, :], s, torch.tensor(-torch.inf))
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(s.shape[:-1] + (hd,))
    for t in range(0, s.shape[-1], 64):
        st = s[..., t:t + 64]
        mn = torch.maximum(m, st.amax(-1))
        alpha = torch.nan_to_num(torch.exp2(m - mn))
        p = torch.nan_to_num(torch.exp2(st - mn[..., None]))
        pb = p.bfloat16().float()
        if hi_lo:
            pb = pb + (p - pb).bfloat16().float()
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bkgs,bskh->bkgh", pb,
                                                v[:, t:t + 64].float())
        m = mn
    return (o / l[..., None]).reshape(b, nq, hd).bfloat16()


@pytest.mark.parametrize("hd", [64, 256])
def test_p_rounded_to_bf16_before_pv_misses_one_step(hd):
    once = ref.decode_rounding_sweep(
        lambda *a: _subtile_decode(*a, hi_lo=False), hd, "cpu")
    assert once["max_err_in_steps"] > 1.0, once
    split = ref.decode_rounding_sweep(
        lambda *a: _subtile_decode(*a, hi_lo=True), hd, "cpu")
    assert split["max_err_in_steps"] <= 0.5 + 1e-3, split
