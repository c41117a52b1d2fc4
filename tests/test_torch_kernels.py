"""Port's attention oracles and dispatch against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same f32 values on both sides.  Tolerances are
those of ``tests/test_kernels.py``: 2e-5 in f32 (the same f32 arithmetic
summed in another order) and 2e-2 in bf16 (one bf16 rounding of the output
and of the probabilities).  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``; ``chip_smoke.py`` at the main path's shapes).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as rk

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

FA_CASES = [
    # b, sq, sk, nq, nkv, hd, causal, window, bq, bk  (tests/test_kernels.py)
    (2, 64, 64, 4, 2, 32, True, 0, 32, 32),
    (1, 128, 128, 8, 8, 64, True, 16, 32, 64),
    (2, 48, 48, 4, 1, 32, True, 0, 16, 16),       # ragged + MQA
    (1, 64, 64, 2, 2, 16, False, 0, 32, 32),       # encoder (non-causal)
    (1, 96, 96, 6, 3, 64, True, 32, 32, 32),       # window + GQA
]
DA_CASES = [
    # b, s, nq, nkv, hd, bk
    (2, 64, 4, 2, 32, 32),
    (1, 100, 8, 1, 64, 32),    # ragged cache + MQA
    (3, 48, 2, 2, 16, 16),
    (1, 256, 16, 4, 64, 128),  # long cache, big block
]


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _err(j_out, t_out) -> float:
    return float(np.max(np.abs(np.asarray(j_out.astype(jnp.float32)) - t_out.float().numpy())))


def _fa_inputs(case, dtype, seed):
    b, sq, sk, nq, nkv, hd = case[:6]
    xs = _normal(seed, (b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd))
    return zip(*(_both(x, dtype) for x in xs))


def _da_inputs(case, dtype, seed):
    b, s, nq, nkv, hd = case[:5]
    q, k, v = _normal(seed, (b, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd))
    valid = np.random.default_rng(seed + 1).uniform(size=(b, s)) < 0.7
    valid[:, 0] = True                            # at least one visible slot
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    return (jq, jk, jv, jnp.asarray(valid)), (tq, tk, tv, torch.from_numpy(valid))


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_matches_jax(case, dtype):
    b, sq, sk, nq, nkv, hd, causal, window = case[:8]
    (jq, jk, jv), (tq, tk, tv) = _fa_inputs(case, dtype, seed=sum(case))
    exp = jref.mha_reference(jq, jk, jv, causal=causal, window=window)
    out = ref.mha_reference(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (b, sq, nq, hd) and out.dtype == DTYPES[dtype][1]
    assert _err(exp, out) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_q_offset_matches_jax(dtype):
    """Chunked prefill: a q block at an absolute offset."""
    (jq, jk, jv), (tq, tk, tv) = _fa_inputs((1, 64, 64, 4, 4, 32), dtype, seed=7)
    exp = jref.mha_reference(jq[:, 32:], jk, jv, causal=True, q_offset=32)
    out = ref.mha_reference(tq[:, 32:], tk, tv, causal=True, q_offset=32)
    assert _err(exp, out) < TOL[dtype]
    full = ref.mha_reference(tq, tk, tv, causal=True)
    assert float((full[:, 32:].float() - out.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("case", DA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reference_matches_jax(case, dtype):
    (jq, jk, jv, jvalid), (tq, tk, tv, tvalid) = _da_inputs(case, dtype, seed=sum(case))
    exp = jref.decode_attention_reference(jq, jk, jv, jvalid)
    out = ref.decode_attention_reference(tq, tk, tv, tvalid)
    assert out.dtype == DTYPES[dtype][1]
    assert _err(exp, out) < TOL[dtype]


def test_decode_reference_single_valid_slot():
    """Softmax over one visible slot == plain value read."""
    q, k, v = (torch.from_numpy(x) for x in _normal(3, (1, 2, 16), (1, 32, 2, 16), (1, 32, 2, 16)))
    valid = torch.zeros((1, 32), dtype=torch.bool)
    valid[:, 5] = True
    out = ref.decode_attention_reference(q, k, v, valid)
    assert float((out - v[:, 5]).abs().max()) < 1e-5


# the Pallas kernels in interpret mode, as tests/test_kernels.py runs them
@pytest.mark.parametrize("case", [FA_CASES[0], FA_CASES[4]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_matches_pallas_interpret(case, dtype):
    causal, window, bq, bk = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _fa_inputs(case, dtype, seed=sum(case) + 1)
    exp = pallas_flash(jq, jk, jv, causal=causal, window=window, block_q=bq, block_k=bk,
                       interpret=True)
    assert _err(exp, ref.mha_reference(tq, tk, tv, causal=causal, window=window)) < TOL[dtype]


@pytest.mark.parametrize("case", [DA_CASES[1], DA_CASES[2]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reference_matches_pallas_interpret(case, dtype):
    (jq, jk, jv, jvalid), (tq, tk, tv, tvalid) = _da_inputs(case, dtype, seed=sum(case) + 1)
    exp = pallas_decode(jq, jk, jv, jvalid, block_k=case[5], interpret=True)
    assert _err(exp, ref.decode_attention_reference(tq, tk, tv, tvalid)) < TOL[dtype]


# kimi-k2's head size 112 (4 q heads over 2 kv heads), which the Pallas
# kernels carry whole in one block: causal, windowed, non-causal at Sq = 4
HD112_FA_CASES = [
    # b, sq, sk, nq, nkv, hd, causal, window, bq, bk
    (1, 96, 96, 4, 2, 112, True, 0, 32, 32),
    (2, 64, 64, 4, 2, 112, True, 24, 32, 32),
    (1, 4, 80, 4, 2, 112, False, 0, 4, 16),
]


@pytest.mark.parametrize("case", HD112_FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_hd112_matches_pallas_interpret(case, dtype):
    causal, window, bq, bk = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _fa_inputs(case, dtype, seed=sum(case))
    exp = pallas_flash(jq, jk, jv, causal=causal, window=window, block_q=bq, block_k=bk,
                       interpret=True)
    out = ref.mha_reference(tq, tk, tv, causal=causal, window=window)
    assert out.shape == tuple(case[:2]) + (4, 112)
    assert _err(exp, out) < TOL[dtype]


@pytest.mark.parametrize("case", [(3, 80, 4, 2, 112, 16), (2, 64, 4, 2, 112, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reference_hd112_matches_pallas_interpret(case, dtype):
    (jq, jk, jv, jvalid), (tq, tk, tv, tvalid) = _da_inputs(case, dtype, seed=sum(case))
    exp = pallas_decode(jq, jk, jv, jvalid, block_k=case[5], interpret=True)
    out = ops.decode_attention(tq, tk, tv, tvalid)
    assert out.shape == (case[0], 4, 112)
    assert _err(exp, out) < TOL[dtype]


@pytest.mark.parametrize("s,window", [(40, 8), (37, 16), (64, 32)])
def test_local_attention_blocked_matches_jax(s, window):
    (jq, jk, jv), (tq, tk, tv) = _fa_inputs((2, s, s, 4, 2, 16), "float32", seed=s)
    exp = jref.local_attention_blocked(jq, jk, jv, window=window)
    out = ref.local_attention_blocked(tq, tk, tv, window=window)
    assert _err(exp, out) < TOL["float32"]
    masked = ref.mha_reference(tq, tk, tv, causal=True, window=window)
    assert float((masked - out).abs().max()) < TOL["float32"]


@pytest.mark.parametrize("s,window,blocked", [(40, 8, True), (16, 8, False), (40, 0, False)])
def test_ops_flash_cpu_dispatch_rule(s, window, blocked):
    """On the CPU, windowed causal self-attention with S > 2W takes the
    blocked path (``repro/kernels/ops.py:43-51``); the result matches the
    JAX dispatch either way."""
    (jq, jk, jv), (tq, tk, tv) = _fa_inputs((1, s, s, 4, 2, 16), "float32", seed=s + window)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    path = ref.local_attention_blocked if blocked else ref.mha_reference
    kw = {"window": window} if blocked else {"causal": True, "window": window}
    assert torch.equal(out, path(tq, tk, tv, **kw))
    exp = jops.flash_attention(jq, jk, jv, causal=True, window=window, impl="xla")
    assert _err(exp, out) < TOL["float32"]


def test_cpu_tensors_never_launch_kernels():
    fa0, da0 = fa.launches, da.launches
    (_, _, _), (tq, tk, tv) = _fa_inputs((1, 16, 16, 2, 2, 16), "float32", seed=0)
    ops.flash_attention(tq, tk, tv)
    (_, _, _, _), (q, k, v, valid) = _da_inputs((1, 16, 2, 2, 16), "float32", seed=0)
    ops.decode_attention(q, k, v, valid)
    assert (fa.launches, da.launches) == (fa0, da0)


def test_kernel_wrappers_refuse_cpu_tensors():
    fa0, da0 = fa.launches, da.launches
    (_, _, _), (tq, tk, tv) = _fa_inputs((1, 16, 16, 2, 2, 16), "float32", seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(tq, tk, tv)
    (_, _, _, _), (q, k, v, valid) = _da_inputs((1, 16, 2, 2, 16), "float32", seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q, k, v, valid)
    assert (fa.launches, da.launches) == (fa0, da0)


def test_ops_refuses_other_devices():
    """A device with neither a kernel nor a plain path raises: no tensor of
    such a device can be made here, so the operand is a stand-in that has
    only a ``device``."""
    q = types.SimpleNamespace(device=torch.device("xpu"))
    for call in (lambda: ops.flash_attention(q, q, q), lambda: ops.decode_attention(q, q, q, q),
                 lambda: ops.rwkv6(q, q, q, q, q)):
        with pytest.raises(ValueError, match="device"):
            call()


def test_meta_tensors_reach_the_plain_versions(monkeypatch):
    """A meta tensor computes no value, so it takes the plain path (the
    dry-run counts a step's operations on meta tensors): flash and decode
    attention reach ``ref``'s plain versions, the WKV recurrence its
    chunk-parallel plain form, the RG-LRU its log-depth scan; no kernel
    launches, and the shapes and dtypes are the plain versions'."""
    called = []

    def spy(name):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, **k: called.append(name) or fn(*a, **k))

    for name in ("mha_reference", "decode_attention_reference",
                 "rwkv6_chunk_parallel_reference"):
        spy(name)
    launched = (fa.launches, da.launches, rk.launches)
    meta = lambda *shape, dtype=torch.bfloat16: torch.empty(shape, dtype=dtype, device="meta")
    q, k = meta(2, 40, 8, 112), meta(2, 40, 2, 112)
    assert ops.flash_attention(q, k, k).shape == q.shape
    o = ops.decode_attention(meta(2, 8, 112), k, k, meta(2, 40, dtype=torch.bool))
    assert o.shape == (2, 8, 112) and o.device.type == "meta"
    r = meta(2, 70, 4, 64)
    out, state = ops.rwkv6(r, r, r, r, meta(4, 64, dtype=torch.float32))
    assert out.shape == r.shape and state.shape == (2, 4, 64, 64)
    assert state.dtype == torch.float32 and state.device.type == "meta"
    h, last = ops.rglru(meta(2, 33, 16), meta(2, 33, 16))
    assert h.shape == (2, 33, 16) and last.shape == (2, 16) and h.device.type == "meta"
    assert called == ["mha_reference", "decode_attention_reference",
                      "rwkv6_chunk_parallel_reference"]
    assert (fa.launches, da.launches, rk.launches) == launched
