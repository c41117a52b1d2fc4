"""The port on the card: CUDA kernels against their plain versions, and the
engine on the card against the engine on the CPU.

These tests need an NVIDIA GPU and nvcc, carry the ``cuda`` marker and skip
without a card.  The file imports no JAX, so it also runs where only
PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 in f32 (the same
f32 arithmetic summed in another order) and 2e-2 in bf16 for attention;
1e-4 and 5e-2 for the RWKV-6 scan, whose chunked form sums decays as
log-space prefixes where the plain version multiplies them token by token.
The MoE layer (PyTorch ops and cuBLAS, no kernel of its own) is held to its
CPU run at 1e-5 in f32 and 2e-2 in bf16, as ``tests/test_torch_moe.py``
holds it to the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import sim as core_sim
from repro_torch.core.sim import torch_engine
from repro_torch.core.workloads import SCENARIO_ZOO
from repro_torch.configs.registry import ModelConfig
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.models import frontends, model, moe
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FA_CASES = [
    # b, sq, sk, nq, nkv, hd, causal, window, q_offset
    (2, 64, 64, 4, 2, 32, True, 0, 0),
    (1, 128, 128, 8, 8, 64, True, 16, 0),
    (2, 48, 48, 4, 1, 32, True, 0, 0),        # ragged + MQA
    (1, 64, 64, 2, 2, 16, False, 0, 0),        # encoder (non-causal)
    (1, 96, 96, 6, 3, 64, True, 32, 0),        # window + GQA
    (1, 32, 64, 4, 4, 32, True, 0, 32),        # chunked prefill: q at an offset
    (1, 200, 200, 4, 2, 128, True, 0, 0),      # hd 128, ragged tiles
    (1, 200, 200, 16, 1, 256, True, 0, 0),     # recurrentgemma-9b: hd 256, MQA 16:1
    (1, 2112, 2112, 16, 1, 256, True, 2048, 0),   # its local window bites (S > W)
    (2, 100, 164, 16, 1, 256, True, 48, 64),   # hd 256, a window and a q_offset
    (8, 1500, 1500, 12, 12, 64, False, 0, 0),  # whisper-small: the encoder over 1500 frames
    (8, 4, 1500, 12, 12, 64, False, 0, 0),     # cross-attention of the 4-token prompt
    (8, 1, 1500, 12, 12, 64, False, 0, 0),     # cross-attention of one decode step
]
DA_CASES = [
    # b, s, nq, nkv, hd
    (2, 64, 4, 2, 32),
    (1, 100, 8, 1, 64),
    (3, 48, 2, 2, 16),
    (1, 256, 16, 4, 64),
    (2, 300, 32, 8, 128),
    (2, 300, 16, 1, 256),      # recurrentgemma-9b: hd 256, 16 q heads over 1 kv head
    (8, 2048, 16, 1, 256),     # and its 8-slot, 2048-slot ring
    (8, 448, 12, 12, 64),      # whisper-small's decoder self-attention: 448-token context
]


RWKV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
RWKV_CASES = [
    # b, t, h, hd, with_state  (tests/test_kernels.py RWKV_CASES, then T = 1 and hd 128)
    (2, 64, 2, 32, False),
    (1, 50, 4, 64, True),      # ragged tail (t % 32 != 0)
    (2, 33, 1, 16, True),
    (1, 128, 2, 64, True),
    (8, 1, 4, 64, True),       # one decode step
    (2, 70, 2, 128, True),
]
RWKV_EDGE_CASES = [
    # b, t, h, hd, with_state: the bf16 prefill's sub-chunk and chunk edges
    # (one launch up to 32 tokens, three above), 64 chunks carried, every
    # head size over several chunks, and rwkv6-1.6b's decode step
    (1, 16, 2, 64, True),
    (1, 17, 2, 64, False),
    (1, 32, 2, 64, True),
    (1, 33, 2, 64, True),
    (1, 2048, 4, 64, True),
    (2, 300, 2, 128, True),
    (3, 97, 5, 16, False),
    (2, 65, 3, 32, True),
    (8, 1, 32, 64, True),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in shapes]


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, sk, nq, nkv, hd, causal, window, q_offset = case
    q, k, v = _randn(sum(case), (b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd),
                     dtype=DTYPES[dtype], device=cuda)
    launches = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert fa.launches == launches + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _err(out, exp) < TOL[dtype]


@pytest.mark.parametrize("case", DA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, s, nq, nkv, hd = case
    q, k, v = _randn(sum(case), (b, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd),
                     dtype=DTYPES[dtype], device=cuda)
    valid = torch.from_numpy(np.random.default_rng(sum(case)).uniform(size=(b, s)) < 0.7)
    valid[:, 0] = True
    valid = valid.to(cuda)
    launches = da.launches
    out = da.decode_attention(q, k, v, valid)
    assert da.launches == launches + 1
    assert _err(out, ref.decode_attention_reference(q, k, v, valid)) < TOL[dtype]


def test_decode_kernel_empty_and_single_slot(cuda):
    q, k, v = _randn(0, (2, 4, 64), (2, 80, 2, 64), (2, 80, 2, 64),
                     dtype=torch.float32, device=cuda)
    valid = torch.zeros((2, 80), dtype=torch.bool, device=cuda)
    valid[1, 37] = True
    out = da.decode_attention(q, k, v, valid)
    assert not out[0].any()                     # no valid slot: 0, as the Pallas kernel
    assert _err(out[1], v[1, 37].repeat_interleave(2, dim=0)) < 1e-6


FA_BF16_VARIANTS = {
    # name: (nq, nkv, causal, window, q_offset)
    "causal_gqa": (8, 2, True, 0, 0),
    "window_q_offset": (4, 4, True, 48, 37),
    "non_causal_gqa": (6, 3, False, 0, 0),
}


@pytest.mark.parametrize("variant", sorted(FA_BF16_VARIANTS))
@pytest.mark.parametrize("s", [1, 63, 65, 1000])
@pytest.mark.parametrize("hd", fa.SUPPORTED_HEAD_DIMS)
def test_flash_bf16_tensor_core_path(cuda, hd, s, variant):
    """The bf16 tensor-core kernel at ragged lengths around its 64-row and
    64-key tiles, for every head dim; keys = queries + q_offset."""
    nq, nkv, causal, window, q_offset = FA_BF16_VARIANTS[variant]
    q, k, v = _randn(hd + s, (1, s, nq, hd), (1, s + q_offset, nkv, hd),
                     (1, s + q_offset, nkv, hd), dtype=torch.bfloat16, device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _err(out, exp) < TOL["bfloat16"]


@pytest.mark.parametrize("variant", sorted(FA_BF16_VARIANTS))
@pytest.mark.parametrize("hd", fa.SUPPORTED_HEAD_DIMS)
def test_flash_bf16_full_grid(cuda, hd, variant):
    """A grid of 16 x 16 heads x 4 sequences = 1024 CTAs, several waves on
    the card, with ragged tiles, GQA, a window and a q_offset."""
    _, _, causal, window, q_offset = FA_BF16_VARIANTS[variant]
    s, nq, nkv = 1000, 16, 4
    q, k, v = _randn(hd, (4, s, nq, hd), (4, s + q_offset, nkv, hd), (4, s + q_offset, nkv, hd),
                     dtype=torch.bfloat16, device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert _err(out, exp) < TOL["bfloat16"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_row_without_visible_key_is_zero(cuda, dtype):
    """A window and a q_offset that put some rows' windows past Sk: those
    rows give 0, as the Pallas kernel does; the others match the plain
    version."""
    sq, sk, q_offset, window = 100, 64, 50, 8
    q, k, v = _randn(3, (1, sq, 4, 64), (1, sk, 2, 64), (1, sk, 2, 64),
                     dtype=DTYPES[dtype], device=cuda)
    out = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=True, window=window, q_offset=q_offset)
    seen = sk + window - 1 - q_offset          # rows [0, seen) see a key
    assert not bool(out[:, seen:].any())
    assert _err(out[:, :seen], exp[:, :seen]) < TOL[dtype]
    none = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=500)
    assert not bool(none.any())


def _decode_check(cuda, dtype, b, s, nq, nkv, hd, valid, seed=0):
    q, k, v = _randn(seed, (b, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd),
                     dtype=DTYPES[dtype], device=cuda)
    valid = valid.to(cuda)
    launches = da.launches
    out = da.decode_attention(q, k, v, valid)
    assert da.launches == launches + 1          # one per call, even with a combine
    exp = ref.decode_attention_reference(q, k, v, valid)
    empty = ~valid.any(dim=1)
    exp = torch.where(empty[:, None, None], torch.zeros_like(exp), exp)
    assert _err(out, exp) < TOL[dtype]
    return q, k, v, out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_empty_tiles_and_splits_in_the_middle(cuda, dtype):
    """Whole 64-slot tiles and whole splits empty between valid slots, a
    sequence with only a single slot in the last split, and one with none."""
    b, s, nq, nkv, hd = 4, 2048, 8, 2, 64
    splits, chunk = da.split_plan(b, nkv, s, torch.cuda.get_device_properties(cuda)
                                  .multi_processor_count)
    assert splits > 2
    valid = torch.zeros((b, s), dtype=torch.bool)
    valid[0, :70] = True
    valid[0, s - 100:] = True                   # tiles and splits between are empty
    valid[1, ::97] = True                       # one slot every 97: most tiles empty
    valid[2, s - 1] = True                      # a single slot, in the last split
    q, k, v, out = _decode_check(cuda, dtype, b, s, nq, nkv, hd, valid)  # row 3: none
    assert not bool(out[3].any())
    assert _err(out[2], v[2, s - 1].repeat_interleave(nq // nkv, dim=0)) < TOL[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_ring_holes(cuda, dtype):
    rng = np.random.default_rng(11)
    valid = torch.ones((8, 1000), dtype=torch.bool)
    for i in range(8):
        for lo in rng.integers(0, 1000, size=4):
            valid[i, lo:lo + int(rng.integers(30, 200))] = False
    valid[:, 500] = True
    _decode_check(cuda, dtype, 8, 1000, 16, 4, 32, valid, seed=11)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_single_slot_cache(cuda, dtype):
    valid = torch.tensor([[True], [False], [True]])
    q, k, v, out = _decode_check(cuda, dtype, 3, 1, 4, 2, 16, valid)
    assert not bool(out[1].any())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_one_split_when_the_grid_is_full(cuda, dtype):
    """S = 4096 at B * nkv = 264 = 2 x 132: the wrapper gives one split on
    an H100, and the CTA writes the output itself."""
    b, nkv, s = 33, 8, 4096
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    if b * nkv >= da.CTAS_PER_SM * sm:
        assert da.split_plan(b, nkv, s, sm) == (1, s)
    valid = torch.from_numpy(np.random.default_rng(2).uniform(size=(b, s)) < 0.5)
    _decode_check(cuda, dtype, b, s, 8, nkv, 64, valid, seed=2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_main_path_prefix_masks(cuda, dtype):
    """qwen1.5-0.5b decode: 8 slots, cache 2048, 16 heads of 64, each slot
    valid up to its prompt + generated tokens."""
    lengths = torch.tensor([96, 544, 300, 65, 64, 1, 2048, 411])
    valid = torch.arange(2048)[None, :] < lengths[:, None]
    _decode_check(cuda, dtype, 8, 2048, 16, 16, 64, valid, seed=5)


def _ring_valid(positions, ring, window):
    """The decode mask of a ring of ``ring`` slots after each sequence wrote
    positions 0..t (slot = pos % ring, the latest write wins), for a window
    of ``window`` positions, as ``attention.attention_decode`` builds it."""
    t = torch.tensor(positions)[:, None]
    slot = torch.arange(ring)[None, :]
    sp = slot + ring * ((t - slot) // ring)          # the latest position p <= t in each slot
    sp = torch.where(sp >= 0, sp, torch.full_like(sp, -1))
    return (sp >= 0) & (sp <= t) & (sp > t - window)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_ring_wrapped_window_mask_hd256(cuda, dtype):
    """recurrentgemma-9b's local attention: 8 slots of a 2048-slot ring that
    has wrapped (t past 2048) under a window that excludes the oldest slots,
    mixed with slots not yet wrapped; hd 256, 16 q heads over 1 kv head."""
    positions = [2100, 4095, 3000, 2047, 100, 5000, 2048, 10]
    valid = _ring_valid(positions, 2048, 1536)
    assert bool((~valid[0]).any()) and bool(valid[0, :53].all())   # wrapped, windowed
    _decode_check(cuda, dtype, 8, 2048, 16, 1, 256, valid, seed=7)


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_bf16_rounding_margin_at_large_outputs(cuda, hd):
    """Outputs of |o| >= 16 made from a few keys (sharp logits, large values),
    held to the f32 attention of the same bf16 inputs within one bf16 step of
    that exact output, ``max(2e-2, 2^(floor(log2|o32|) - 7))``.  The TPU
    kernel computes in f32 from its bf16 inputs and rounds once, at the
    output, so this is what it meets (tests/test_torch_flash_rounding.py);
    the plain version rounds its probabilities to bf16 first and sits up to
    one step away on its own side, so no kernel can be held to it at 2e-2
    once a step exceeds 4e-2."""
    q, k, v = ref.large_output_inputs(hd, cuda)
    out = fa.flash_attention(q, k, v, causal=True)
    o32 = ref.mha_reference(q.float(), k.float(), v.float(), causal=True)
    assert float(o32.abs().max()) >= 16.0
    steps = ref.bf16_steps_from_f32(out, q, k, v, causal=True)
    worst = int(steps.argmax())
    assert float(steps.max()) <= 1.0, (
        f"kernel {float(out.flatten()[worst])} vs f32 {float(o32.flatten()[worst])}, "
        f"{float(steps.max())} bf16 steps")


@pytest.mark.parametrize("hd", [64, 256])
def test_decode_bf16_rounding_margin_at_large_outputs(cuda, hd):
    """A decode step with outputs of |o| >= 16 made from a few slots
    (sharp logits, large values), 16 q heads over 4 kv heads at hd 64 and
    over 1 at hd 256, held to the f32 attention of the same bf16 inputs
    within one bf16 step of that exact output,
    ``max(2e-2, 2^(floor(log2|o32|) - 7))``: the TPU kernel keeps P in f32
    and rounds once, at the output, and meets half of it
    (tests/test_torch_decode_rounding.py).  Then the same over the 64
    input sets of ``ref.DECODE_ROUNDING_SEEDS``."""
    q, k, v, valid = ref.large_output_decode_inputs(hd, cuda)
    out = da.decode_attention(q, k, v, valid)
    o32 = ref.decode_attention_reference(q.float(), k.float(), v.float(), valid)
    assert float(o32.abs().max()) >= 16.0
    steps = ref.bf16_steps_from_f32(out, q, k, v, valid=valid)
    worst = int(steps.argmax())
    assert float(steps.max()) <= 1.0, (
        f"kernel {float(out.flatten()[worst])} vs f32 {float(o32.flatten()[worst])}, "
        f"{float(steps.max())} bf16 steps")
    sweep = ref.decode_rounding_sweep(da.decode_attention, hd, cuda)
    assert sweep["max_err_in_steps"] <= 1.0, sweep


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _randn(0, (1, 8, 2, 48), (1, 8, 2, 48), (1, 8, 2, 48),
                     dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _randn(0, (1, 8, 2, 64), (1, 8, 2, 64), (1, 8, 2, 64),
                     dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k, v)
    q, k, v = _randn(0, (1, 8, 2, 64), (1, 2, 8, 64), (1, 8, 2, 64),
                     dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(1, 2), v)


def _rwkv_inputs(case, dtype, device, strong=False, scale=1.0):
    """The distribution of tests/test_kernels.py: r, k ~ 0.5 N, v ~ N, w in
    (0.45, 0.95) (strong: exp(-exp(U(-2, 4))), down to 1e-24), u ~ 0.3 N f32,
    state ~ 0.2 N f32; ``scale`` multiplies r, k and v."""
    b, t, h, hd, with_state = case
    rng = np.random.default_rng(sum(case) + strong)
    x = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sh = (b, t, h, hd)
    if strong:
        w = np.exp(-np.exp(rng.uniform(-2.0, 4.0, sh))).astype(np.float32)
    else:
        w = (1 / (1 + np.exp(-(x(*sh) * 2 - 1))) * 0.5 + 0.45).astype(np.float32)
    to = lambda a, dt: torch.from_numpy(a).to(device, dt)
    r, k, v, w = (to(a, dtype) for a in (x(*sh) * 0.5 * scale, x(*sh) * 0.5 * scale,
                                         x(*sh) * scale, w))
    u = to(x(h, hd) * 0.3, torch.float32)
    s0 = to(x(b, h, hd, hd) * 0.2, torch.float32) if with_state else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("case", RWKV_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_kernel_matches_plain(cuda, case, dtype):
    r, k, v, w, u, s0 = _rwkv_inputs(case, DTYPES[dtype], cuda)
    launches = rk.launches
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert rk.launches == launches + 1
    assert out.dtype == r.dtype and out.shape == r.shape and s_t.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())
    assert _err(out, exp_o) < RWKV_TOL[dtype]
    assert _err(s_t, exp_s) < RWKV_TOL[dtype]


@pytest.mark.parametrize("case", RWKV_EDGE_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_kernel_chunk_edges_and_long_t(cuda, case, dtype):
    """r, k, v halved so that |o| stays below 8, where one bf16 step (0.0625)
    would exceed the tolerance by rounding alone; one launch count a call,
    however many kernels it runs."""
    r, k, v, w, u, s0 = _rwkv_inputs(case, DTYPES[dtype], cuda, scale=0.5)
    launches = rk.launches
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert rk.launches == launches + 1
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())
    assert _err(out, exp_o) < RWKV_TOL[dtype]
    assert _err(s_t, exp_s) < RWKV_TOL[dtype]


def test_rwkv6_kernel_strong_decay_bf16(cuda):
    """Strong decay through the bf16 prefill's three kernels."""
    r, k, v, w, u, s0 = _rwkv_inputs((1, 100, 4, 64, True), torch.bfloat16, cuda, strong=True)
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())
    assert _err(out, exp_o) < 5e-2 and _err(s_t, exp_s) < 5e-2


@pytest.mark.parametrize("t", [45, 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_kernel_in_place_in_both_regimes(cuda, t, dtype):
    """``final_state=state`` through the prefill's kernels (T = 45) and the
    one-token kernel (T = 1): the result of a separate final state, within
    tolerance of the plain version."""
    r, k, v, w, u, s0 = _rwkv_inputs((2, t, 4, 64, True), DTYPES[dtype], cuda)
    out_sep, s_sep = rk.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    out_in, s_in = rk.rwkv6_scan(r, k, v, w, u, state, final_state=state)
    assert s_in is state
    assert torch.equal(out_in, out_sep) and torch.equal(state, s_sep)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert _err(out_in, exp_o) < RWKV_TOL[dtype] and _err(state, exp_s) < RWKV_TOL[dtype]


def test_rwkv6_kernel_strong_decay_stays_finite(cuda):
    """Decay down to exp(-exp(4)) ~ 1e-24 (tests/test_kernels.py): every
    factor the kernel exponentiates is <= 1, so nothing overflows."""
    r, k, v, w, u, _ = _rwkv_inputs((1, 64, 1, 16, False), torch.float32, cuda, strong=True)
    out, s_t = rk.rwkv6_scan(r, k, v, w, u)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u)
    assert bool(torch.isfinite(out).all())
    assert _err(out, exp_o) < 1e-4 and _err(s_t, exp_s) < 1e-4


def test_rwkv6_kernel_updates_the_state_in_place(cuda):
    """With ``final_state=state`` the kernel overwrites the state it read,
    and the result is the one of a separate output."""
    r, k, v, w, u, s0 = _rwkv_inputs((2, 45, 4, 64, True), torch.float32, cuda)
    out_sep, s_sep = rk.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    out_in, s_in = ops.rwkv6(r, k, v, w, u, state, final_state=state)
    assert s_in is state
    assert torch.equal(out_in, out_sep) and torch.equal(state, s_sep)


def test_rwkv6_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    r, k, v, w, u, s0 = _rwkv_inputs((1, 8, 2, 64, True), torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        rk.rwkv6_scan(*(x.half() for x in (r, k, v, w)), u, s0)
    with pytest.raises(TypeError, match="dtype"):
        rk.rwkv6_scan(r, k, v, w, u, s0.bfloat16())           # the state is f32
    with pytest.raises(TypeError, match="dtype"):
        rk.rwkv6_scan(r, k, v, w, u.bfloat16(), s0)           # so is u
    with pytest.raises(ValueError, match="contiguous"):
        rk.rwkv6_scan(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, w, u, s0)
    r48, k48, v48, w48, u48, _ = _rwkv_inputs((1, 8, 2, 48, False), torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        rk.rwkv6_scan(r48, k48, v48, w48, u48)
    with pytest.raises(ValueError, match="CUDA"):
        rk.rwkv6_scan(*(x.cpu() for x in (r, k, v, w, u)))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(t, device) for k, t in tree.items()}
    if isinstance(tree, list):
        return [_to(t, device) for t in tree]
    return tree.to(device)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b", "phi3.5-moe-42b-a6.6b",
                                  "recurrentgemma-9b"])
def test_engine_on_the_card_matches_cpu(cuda, arch):
    """In f32 the engine's greedy tokens on the card (CUDA kernels) equal
    those on the CPU (plain versions) for the same weights."""
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    noise = torch.Generator().manual_seed(1)
    for layer in params["layers"]:            # RWKV's zero-initialised leaves
        for name in ("mu", "cm_mu", "w0", "u"):
            if "rwkv" in layer:
                leaf = layer["rwkv"][name]
                leaf.copy_(0.3 * torch.randn(leaf.shape, generator=noise))
    on_card = _to(params, cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 17)]
    outs = []
    for device, p in (("cpu", params), ("cuda", on_card)):
        eng = Engine(cfg, p, EngineConfig(slots=2, cache_len=64, max_new_tokens=4, device=device))
        bat = ContinuousBatcher(eng)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=4) for i, pr in enumerate(prompts)]
        for r in reqs:
            bat.submit(r)
        bat.run_until_idle()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_whisper_on_the_card_matches_cpu(cuda):
    """whisper-small at ``reduced()`` in f32: ``prefill(enc_inputs=)`` and 4
    decode steps on the card (CUDA kernels) against the CPU (plain
    versions), the CPU's greedy tokens fed to both.  Logits within 1e-3, as
    ``chip_smoke.py`` holds f32 logits (the same f32 arithmetic summed in
    another order through 2 + 2 layers), the same greedy tokens, and every
    attention call through the kernels: per prefill 2 encoder, 2 self- and 2
    cross-attention flash calls, per step 2 cross-attention flash calls
    (Sq = 1) and 2 decode calls."""
    cfg = get_config("whisper-small").reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    frames = torch.from_numpy(frontends.audio_frames(cfg, 2, seed=3))
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 4)))
    runs, fed = [], None
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        before = (fa.launches, da.launches)
        cache = model.init_cache(cfg, 2, 16, device=device)
        logits, cache = model.prefill(cfg, p, prompt.to(device), cache,
                                      enc_inputs=frames.to(device))
        out = [logits.cpu()]
        for i in range(4):
            tok = fed[i] if fed is not None else torch.argmax(out[-1], dim=-1)
            logits, cache = model.decode_step(cfg, p, tok.to(device), cache)
            out.append(logits.cpu())
        fed = fed or [torch.argmax(x, dim=-1) for x in out[:-1]]
        runs.append((out, fa.launches - before[0], da.launches - before[1]))
    (cpu, _, _), (card, flash_calls, decode_calls) = runs
    assert (flash_calls, decode_calls) == (3 * 2 + 4 * 2, 4 * 2)
    assert max(_err(a, b) for a, b in zip(card, cpu)) < 1e-3
    assert all(torch.equal(torch.argmax(a, -1), torch.argmax(b, -1)) for a, b in zip(card, cpu))


# ---------------------------------------------------------------------------
# The MoE layer on the card.
# ---------------------------------------------------------------------------
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MOE_CASES = [
    # experts, top-k, d, expert ff, tokens (B, S), capacity (None: from the shapes)
    (4, 1, 32, 64, (2, 16), None),     # tests/test_moe.py's routes
    (4, 2, 32, 64, (2, 16), None),
    (8, 2, 32, 64, (2, 16), None),
    (3, 2, 32, 64, (2, 16), None),
    (4, 2, 32, 64, (1, 32), 8),        # capacity 8 for 64 assignments: drops
    (16, 2, 256, 512, (1, 64), None),  # phi's routing, narrow: a batch-1 prefill
    (16, 2, 256, 512, (8, 1), None),   # and an 8-slot decode step
]


def _moe_layer(case, dtype, device):
    e, k, d, ff, shape, _ = case
    cfg = ModelConfig(name="moe-card", family="moe", num_layers=1, d_model=d, num_heads=4,
                      num_kv_heads=4, d_ff=ff, expert_d_ff=ff, vocab_size=64, num_experts=e,
                      num_experts_per_tok=k)
    p = moe.init_moe(torch.Generator().manual_seed(e + k), cfg, DTYPES[dtype], "cpu")
    [x] = _randn(d + shape[1], (*shape, d), dtype=DTYPES[dtype], device="cpu")
    return cfg, p, x, {n: t.to(device) for n, t in p.items()}, x.to(device)


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_sort_local_on_the_card_matches_cpu(cuda, case, dtype):
    cfg, p, x, p_card, x_card = _moe_layer(case, dtype, cuda)
    y, aux = moe.moe_sort_local(cfg, p, x, capacity=case[-1])
    y_card, aux_card = moe.moe_sort_local(cfg, p_card, x_card, capacity=case[-1])
    assert y_card.dtype == x.dtype and y_card.shape == x.shape
    assert _err(y_card.cpu(), y) < MOE_TOL[dtype]
    assert abs(float(aux_card) - float(aux)) < 1e-6


@pytest.mark.parametrize("case", [MOE_CASES[4], MOE_CASES[5], MOE_CASES[6]])
def test_moe_forward_does_not_wait_on_the_card(cuda, case):
    """No step of the sort path syncs with the host: under the sync debug
    mode "error" any op that waits on the card raises."""
    cfg, _, _, p_card, x_card = _moe_layer(case, "bfloat16", cuda)
    moe.moe_sort_local(cfg, p_card, x_card, capacity=case[-1])      # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_sort_local(cfg, p_card, x_card, capacity=case[-1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(aux))



# ---------------------------------------------------------------------------
# The control plane: the batched tick engine on the card against the CPU.
# ---------------------------------------------------------------------------
SIM_POOL = ["llama3-8b", "qwen1.5-0.5b", "rwkv6-1.6b", "minicpm-2b"]


@pytest.mark.parametrize("policy,catalog", [("portfolio", False), ("rl_pool", False),
                                            ("infaas_variant", True), ("rl_pool", True)])
def test_tick_engine_on_the_card_matches_cpu(cuda, policy, catalog):
    """run_grid over 3 cells of 8 archs on the card (float64, its tick loop
    under sync debug mode "error") equals the same run on the CPU: raw ledger
    totals at 1e-6 relative, equal summary keys, and the per-arch flows."""
    wl = core_sim.replicate_pool(SIM_POOL, 8, strict_frac=0.25)
    if catalog:
        wl = [dataclasses.replace(w, min_accuracy=0.55) for w in wl]
    cat = core_sim.VariantCatalog.for_workload(wl) if catalog else None
    arrs = np.stack([SCENARIO_ZOO[n].build(8, duration_s=400, mean_rps=300.0, seed=i)
                     for i, n in enumerate(("trending_hotswap", "mmpp_bursts", "flash_anti"))])
    runs = [torch_engine.run_grid(arrs, wl, policy, seeds=[3, 4, 5], catalog=cat, device=d)
            for d in (cuda, "cpu")]
    for card, cpu in zip(*runs):
        assert set(card["summary"]) == set(cpu["summary"])
        assert card["summary"].get("variant_swaps") == cpu["summary"].get("variant_swaps")
        a, b = card["ledger"], cpu["ledger"]
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-6), k
        for k in ("served_vm", "served_burst", "dropped", "violations", "acc_weight"):
            np.testing.assert_allclose(card["per_arch"][k], cpu["per_arch"][k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
