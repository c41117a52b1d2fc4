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
holds it to the JAX package.  The autograd Functions of ``kernels/ops.py``
(kernel forward, plain-VJP backward) give the plain version's gradients to
1e-6 of their largest value (the backward is that VJP, on the same inputs),
and a train step on the card is held to the CPU at ``chip_smoke.py``
phase 6b's tolerances.
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
from repro_torch.models.params import values_of
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
    # hd 256 at 16:1 across the kernel's 64-row blocks and 64-key tiles
    *((1, sq, sk, 16, 1, 256, causal, 0, 0)
      for sq in (127, 129) for sk in (127, 129) for causal in (True, False)),
    # and across the f32 kernel's: 64-row blocks and 32-key tiles on each
    # CTA of a cluster of two
    *((1, sq, sk, 16, 1, 256, causal, 0, 0)
      for sq in (63, 65) for sk in (31, 33, 63, 65) for causal in (True, False)),
    (8, 1500, 1500, 12, 12, 64, False, 0, 0),  # whisper-small: the encoder over 1500 frames
    (8, 4, 1500, 12, 12, 64, False, 0, 0),     # cross-attention of the 4-token prompt
    (8, 1, 1500, 12, 12, 64, False, 0, 0),     # cross-attention of one decode step
    (1, 512, 512, 64, 8, 112, True, 0, 0),     # kimi-k2: hd 112, 64 q heads over 8 kv heads
    (1, 2048, 2048, 64, 8, 112, True, 0, 0),   # and a 2048-token prompt
    (1, 200, 264, 16, 2, 112, True, 0, 64),    # hd 112, ragged tiles, a q_offset
    (2, 4, 300, 8, 8, 112, False, 0, 0),       # hd 112 non-causal at Sq = 4
    (1, 150, 150, 8, 2, 112, True, 48, 0),     # hd 112 under a window
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
    (8, 2048, 64, 8, 112),     # kimi-k2: hd 112, 64 q heads over 8 kv heads, 8 slots
    (3, 300, 16, 2, 112),      # hd 112, a ragged cache
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
    # b, t, h, hd, with_state: the prefill's sub-chunk and chunk edges (one
    # rank up to 32 tokens, a cluster of ranks above), 64 chunks over 16
    # ranks of 4, every head size over several chunks, and rwkv6-1.6b's
    # decode step
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
    return float((a.detach().float() - b.detach().float()).abs().max())


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
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bf16_tensor_core_path(cuda, dtype, hd, s, variant):
    """The tensor-core kernels (bf16; f32 at hd <= 128 as three tf32
    products) at ragged lengths around their row blocks (64 rows a
    warpgroup or CTA) and key tiles (64; f32 at hd 112 and 128: 32), for
    every head dim; keys = queries + q_offset."""
    nq, nkv, causal, window, q_offset = FA_BF16_VARIANTS[variant]
    q, k, v = _randn(hd + s, (1, s, nq, hd), (1, s + q_offset, nkv, hd),
                     (1, s + q_offset, nkv, hd), dtype=DTYPES[dtype], device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert out.dtype == DTYPES[dtype] and out.shape == q.shape
    assert _err(out, exp) < TOL[dtype]


@pytest.mark.parametrize("variant", sorted(FA_BF16_VARIANTS))
@pytest.mark.parametrize("hd", fa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bf16_full_grid(cuda, dtype, hd, variant):
    """A grid of 16 x 16 heads x 4 sequences = 1024 CTAs (f32 at hd 112
    and 128: 2048), several waves on the card, with ragged tiles, GQA, a
    window and a q_offset, in bf16 and f32."""
    _, _, causal, window, q_offset = FA_BF16_VARIANTS[variant]
    s, nq, nkv = 1000, 16, 4
    q, k, v = _randn(hd, (4, s, nq, hd), (4, s + q_offset, nkv, hd), (4, s + q_offset, nkv, hd),
                     dtype=DTYPES[dtype], device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert _err(out, exp) < TOL[dtype]


TILE_EDGES = (1, 127, 128, 129)


@pytest.mark.parametrize("sq", TILE_EDGES)
@pytest.mark.parametrize("sk", TILE_EDGES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bf16_tile_edges(cuda, dtype, sq, sk, causal, hd):
    """The wgmma kernels' row blocks (bf16 and f32 at hd 64: 128 rows, two
    consumers of 64; f32 at hd 128: 64 rows, one consumer) and key tiles
    (64; f32 at hd 128: 32): Sq and Sk on either side of each edge, 8 q
    heads over 2 kv heads, causal and not."""
    q, k, v = _randn(sq * 1000 + sk, (2, sq, 8, hd), (2, sk, 2, hd), (2, sk, 2, hd),
                     dtype=DTYPES[dtype], device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal)
    exp = ref.mha_reference(q, k, v, causal=causal)
    assert out.shape == q.shape
    assert _err(out, exp) < TOL[dtype]


FA_GQA_WINDOW_CASES = [
    # b, sq, sk, nq, nkv, hd, causal, window, q_offset
    (1, 129, 129, 64, 8, 112, True, 0, 0),     # kimi-k2's 64:8 across a row block
    (1, 129, 129, 64, 8, 128, True, 0, 0),
    (2, 129, 300, 16, 1, 64, False, 0, 0),     # MQA 16:1
    (1, 300, 300, 16, 1, 128, True, 0, 0),
    (1, 200, 300, 8, 2, 64, True, 100, 70),    # window edge and q_offset across tiles
    (1, 129, 300, 4, 4, 128, True, 64, 37),
    (1, 129, 300, 64, 8, 112, True, 48, 150),
]


@pytest.mark.parametrize("case", FA_GQA_WINDOW_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bf16_gqa_and_windows_across_tiles(cuda, dtype, case):
    b, sq, sk, nq, nkv, hd, causal, window, q_offset = case
    q, k, v = _randn(sum(case), (b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd),
                     dtype=DTYPES[dtype], device=cuda)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert _err(out, exp) < TOL[dtype]


@pytest.mark.parametrize("hd", [64, 112, 128, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bf16_rows_without_visible_key_across_a_row_block(cuda, dtype, hd):
    """Rows 79 and on see no key under a window past Sk, so every row block
    from row 128 on (one of 128 rows; two of 64 in f32 at hd 112 and 128,
    and at hd 256, whose f32 clusters of two CTAs then exchange nothing)
    walks no KV tile at all: they give 0, and the rows before them match
    the plain version; and a CTA whose second consumer, where it has two,
    has no row (Sq = 4)."""
    sq, sk, q_offset, window = 200, 100, 40, 20
    q, k, v = _randn(hd, (1, sq, 8, hd), (1, sk, 2, hd), (1, sk, 2, hd),
                     dtype=DTYPES[dtype], device=cuda)
    out = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=True, window=window, q_offset=q_offset)
    seen = sk + window - 1 - q_offset          # rows [0, seen) see a key
    assert not bool(out[:, seen:].any())
    assert _err(out[:, :seen], exp[:, :seen]) < TOL[dtype]
    short = fa.flash_attention(q[:, :4].contiguous(), k, v, causal=False)
    assert _err(short, ref.mha_reference(q[:, :4], k, v, causal=False)) < TOL[dtype]


@pytest.mark.parametrize("hd", [64, 112, 128, 256])
def test_flash_f32_as_close_to_float64_as_plain_at_large_outputs(cuda, hd):
    """Where outputs reach |o| ~ 27 (``ref.large_output_inputs``) no f32
    kernel meets 2e-5 against the plain version, which is itself ~1e-4 from
    a float64 attention: the f32 kernel's three tf32 products stay within
    1.5 times the plain version's distance from float64."""
    q, k, v = ref.large_output_inputs(hd, cuda, torch.float32)
    o64 = ref.attention_f64(q, k, v, causal=True)
    assert float(o64.abs().max()) >= 16.0
    plain = _err(ref.mha_reference(q, k, v, causal=True).double(), o64)
    assert _err(fa.flash_attention(q, k, v, causal=True).double(), o64) <= 1.5 * plain


def test_tf32_probe_reads_f32_operands_truncated(cuda):
    """The f32 kernel takes Q and K as they land for their tf32 parts: the
    tensor cores must read an f32 operand as its top 19 bits, from shared
    memory and, in the A fragment's layout, from registers."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32))
    d_ss, d_rs = fa.tf32_probe(a.to(cuda))
    assert torch.equal(d_ss.cpu(), ref.tf32(a))
    assert torch.equal(d_rs.cpu(), ref.tf32(a))


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
    assert da.launches == launches + 1          # one per call
    exp = ref.decode_attention_reference(q, k, v, valid)
    empty = ~valid.any(dim=1)
    exp = torch.where(empty[:, None, None], torch.zeros_like(exp), exp)
    assert _err(out, exp) < TOL[dtype]
    return q, k, v, out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_empty_tiles_and_splits_in_the_middle(cuda, dtype):
    """Whole 64-slot tiles empty between valid slots (a cluster rank may see
    none of the valid ones), a sequence with only a single slot in the last
    tile, and one with none."""
    b, s, nq, nkv, hd = 4, 2048, 8, 2, 64
    clusters = da.cluster_plan(b, nkv, s, torch.cuda.get_device_properties(cuda)
                               .multi_processor_count)
    assert clusters > 2
    valid = torch.zeros((b, s), dtype=torch.bool)
    valid[0, :70] = True
    valid[0, s - 100:] = True                   # tiles between are empty
    valid[1, ::97] = True                       # one slot every 97: most tiles empty
    valid[2, s - 1] = True                      # a single slot, in the last tile
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
    """S = 4096 at B * nkv = 264 = 2 x 132: the wrapper gives clusters of
    one CTA on an H100, which writes the output itself."""
    b, nkv, s = 33, 8, 4096
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    if b * nkv >= da.CTAS_PER_SM * sm:
        assert da.cluster_plan(b, nkv, s, sm) == 1
    valid = torch.from_numpy(np.random.default_rng(2).uniform(size=(b, s)) < 0.5)
    _decode_check(cuda, dtype, b, s, 8, nkv, 64, valid, seed=2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_cluster_of_16_at_recurrentgemma(cuda, dtype, monkeypatch):
    """recurrentgemma-9b's decode: 8 (sequence, kv head) pairs, so the shape
    rule asks clusters of 16 CTAs (above 8: a non-portable size), which the
    card must be able to hold.  Launched at 16, then at the size the
    wrapper picks (one wave on this card); prefix masks of the main path's
    lengths, then a window over a wrapped ring."""
    b, s, nq, nkv, hd = 8, 2048, 16, 1, 256
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert da.cluster_plan(b, nkv, s, sm) > 8
    assert da.max_active_clusters(DTYPES[dtype], hd, nq // nkv, 16, cuda) >= 1
    lengths = torch.tensor([96, 544, 300, 65, 64, 1, 2048, 411])
    masks = (torch.arange(s)[None, :] < lengths[:, None],
             _ring_valid([2100, 4095, 3000, 2047, 100, 5000, 2048, 10], s, 1536))
    with monkeypatch.context() as patch:
        patch.setattr(da, "cluster_plan", lambda *args: 16)
        for i, valid in enumerate(masks):
            _decode_check(cuda, dtype, b, s, nq, nkv, hd, valid, seed=16 + i)
    assert da.clusters_for(b, s, nq, nkv, hd, DTYPES[dtype], cuda) >= 1
    for i, valid in enumerate(masks):
        _decode_check(cuda, dtype, b, s, nq, nkv, hd, valid, seed=18 + i)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_cluster_ranks_without_a_tile(cuda, dtype):
    """Whole cluster ranks get no valid tile: prefixes of 1, 64 and 65
    slots (one or two tiles of a 16-rank cluster), and a sequence whose
    valid slots all lie in the tiles of rank 0 (tiles 0, C, 2C, ...)."""
    b, s, nq, nkv, hd = 4, 2048, 16, 1, 64
    clusters = da.cluster_plan(b, nkv, s, torch.cuda.get_device_properties(cuda)
                               .multi_processor_count)
    assert clusters > 2
    valid = torch.zeros((b, s), dtype=torch.bool)
    valid[0, :1] = True
    valid[1, :64] = True
    valid[2, :65] = True
    for t in range(0, s // 64, clusters):
        valid[3, 64 * t + 5:64 * t + 40] = True
    _decode_check(cuda, dtype, b, s, nq, nkv, hd, valid, seed=18)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_masked_slots_hold_large_values(cuda, dtype):
    """The kernel reads whole 64-slot tiles, masked slots too, and gives
    them probability exactly 0: masked K/V slots holding +-1e4 do not move
    the output (bit for bit against the same call with them zero)."""
    b, s, nq, nkv = 8, 1000, 16, 2
    for hd in (64, 128):
        valid = torch.from_numpy(np.random.default_rng(hd).uniform(size=(b, s)) < 0.5)
        valid[:, 0] = True
        q, k, v, out = _decode_check(cuda, dtype, b, s, nq, nkv, hd, valid, seed=hd)
        masked = ~valid.to(cuda)[:, :, None, None]
        zero = da.decode_attention(q, torch.where(masked, 0, k), torch.where(masked, 0, v),
                                   valid.to(cuda))
        sign = torch.where(torch.rand(k.shape, device=cuda) < 0.5, -1e4, 1e4).to(k.dtype)
        big = da.decode_attention(q, torch.where(masked, sign, k), torch.where(masked, -sign, v),
                                  valid.to(cuda))
        assert torch.equal(big, zero)
        assert _err(big, out) < TOL[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_main_path_prefix_masks(cuda, dtype):
    """qwen1.5-0.5b decode: 8 slots, cache 2048, 16 heads of 64, each slot
    valid up to its prompt + generated tokens."""
    lengths = torch.tensor([96, 544, 300, 65, 64, 1, 2048, 411])
    valid = torch.arange(2048)[None, :] < lengths[:, None]
    _decode_check(cuda, dtype, 8, 2048, 16, 16, 64, valid, seed=5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_hd112_prefix_masks_and_empty_splits(cuda, dtype):
    """kimi-k2 decode: 8 slots, cache 2048, 64 q heads over 8 kv heads of
    112, each slot valid up to its prompt + generated tokens; then masks
    that leave whole tiles empty, one slot alone in the last tile and a
    sequence with none."""
    lengths = torch.tensor([96, 544, 300, 65, 64, 1, 2048, 411])
    valid = torch.arange(2048)[None, :] < lengths[:, None]
    _decode_check(cuda, dtype, 8, 2048, 64, 8, 112, valid, seed=9)
    valid = torch.zeros((4, 2048), dtype=torch.bool)
    valid[0, :70] = True
    valid[0, -100:] = True
    valid[1, ::97] = True
    valid[2, -1] = True
    q, k, v, out = _decode_check(cuda, dtype, 4, 2048, 64, 8, 112, valid, seed=10)
    assert not bool(out[3].any())
    assert _err(out[2], v[2, -1].repeat_interleave(8, dim=0)) < TOL[dtype]


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


@pytest.mark.parametrize("hd", [64, 112, 128, 256])
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


@pytest.mark.parametrize("hd", [64, 112, 256])
def test_decode_bf16_rounding_margin_at_large_outputs(cuda, hd):
    """A decode step with outputs of |o| >= 16 made from a few slots
    (sharp logits, large values), 16 q heads over 4 kv heads at hd 64 and
    112 and over 1 at hd 256, held to the f32 attention of the same bf16 inputs
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_wrappers_take_hd_112_and_refuse_hd_80(cuda, dtype):
    """Both attention wrappers launch at kimi-k2's head size 112 and still
    refuse a head size no kernel is built for (80)."""
    for hd, ok in ((112, True), (80, False)):
        q, k, v = _randn(hd, (1, 70, 8, hd), (1, 70, 2, hd), (1, 70, 2, hd),
                         dtype=DTYPES[dtype], device=cuda)
        qd = q[:, -1].contiguous()
        valid = torch.ones((1, 70), dtype=torch.bool, device=cuda)
        if ok:
            assert _err(fa.flash_attention(q, k, v), ref.mha_reference(q, k, v)) < TOL[dtype]
            assert (_err(da.decode_attention(qd, k, v, valid),
                         ref.decode_attention_reference(qd, k, v, valid)) < TOL[dtype])
        else:
            with pytest.raises(ValueError, match="head_dim"):
                fa.flash_attention(q, k, v)
            with pytest.raises(ValueError, match="head_dim"):
                da.decode_attention(qd, k, v, valid)


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
    """Strong decay through the bf16 cluster kernel (four ranks)."""
    r, k, v, w, u, s0 = _rwkv_inputs((1, 100, 4, 64, True), torch.bfloat16, cuda, strong=True)
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())
    assert _err(out, exp_o) < 5e-2 and _err(s_t, exp_s) < 5e-2


@pytest.mark.parametrize("t", [45, 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_kernel_in_place_in_both_regimes(cuda, t, dtype):
    """``final_state=state`` through the cluster kernel (T = 45) and the
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
    p = values_of(moe.init_moe(torch.Generator().manual_seed(e + k), cfg, DTYPES[dtype], "cpu"))
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




def test_ep_a2a_at_one_nccl_rank_is_the_sort_path(cuda, tmp_path):
    """Expert parallelism on a (1, 1) ``DeviceMesh`` of one NCCL rank (the
    JAX package's ``test_ep_a2a_single_device_mesh``): one shard's capacity
    is the batch's, aux is the same and the all-to-alls copy, so y, aux and
    the gradients of ``sum(y²) + 0.01·aux`` are the sort path's, at the f32
    tolerance, on phi's routing at a 64-token prefill."""
    import torch.distributed as dist

    from repro_torch.distributed import AxisRules, axis_rules
    from repro_torch.launch.mesh import make_test_mesh

    cfg, _, _, p_card, x_card = _moe_layer(MOE_CASES[5], "float32", cuda)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        rules = AxisRules(make_test_mesh((1, 1)), {"experts": "model", "batch": ("data",)})
        runs = {}
        for path in ("ep_a2a", "local"):
            inputs = {k: v.clone().requires_grad_(True) for k, v in {**p_card, "x": x_card}.items()}
            with axis_rules(rules):
                y, aux = moe.moe_apply(cfg, {k: v for k, v in inputs.items() if k != "x"},
                                       inputs["x"], path=path)
                ((y ** 2).sum() + 0.01 * aux).backward()
            runs[path] = {"y": y.detach(), "aux": aux.detach(),
                          **{f"grad_{k}": v.grad for k, v in inputs.items()}}
    finally:
        dist.destroy_process_group()
    for key, want in runs["local"].items():
        assert _err(runs["ep_a2a"][key], want) <= MOE_TOL["float32"] * float(want.abs().max()), key

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


# ---------------------------------------------------------------------------
# The PPO controller: rollouts and updates on the card against the CPU.
# ---------------------------------------------------------------------------
def _ppo_env(catalog):
    from repro_torch.core.rl import EnvConfig, PoolServingEnv

    wl = core_sim.uniform_pool_workload(SIM_POOL, strict_frac=0.25)
    wl = [dataclasses.replace(w, min_accuracy=0.5) for w in wl]
    cat = core_sim.VariantCatalog.for_workload(wl) if catalog else None
    scs = [SCENARIO_ZOO[n] for n in ("mmpp_bursts", "flash_anti", "trending_hotswap")]
    return PoolServingEnv(wl, EnvConfig(mean_rps=200.0, duration_s=300,
                                        accuracy_bonus=0.001),
                          scenarios=scs, scenario_seed=1, catalog=cat)


@pytest.mark.parametrize("catalog", [False, True])
def test_ppo_collectors_on_the_card_match_cpu(cuda, catalog):
    """Both collectors on the card (the live net on the card, the tick loop
    under sync debug mode "error") equal the CPU: the same actions, the
    other buffers at 1e-6."""
    from repro_torch.core.rl import ppo

    net = ppo.init_net(torch.Generator().manual_seed(0), ppo.PPOConfig())
    net["pi"]["w"] = net["pi"]["w"] * 100.0
    u = np.random.default_rng(1).random((3, 300, len(SIM_POOL)))
    runs = []
    for dev in (cuda, "cpu"):
        params = ppo.params_from_jax(net, device=dev)
        env = _ppo_env(catalog)
        runs.append((ppo.collect_rollouts_torch(env, params, u[0], device=dev),
                     ppo.collect_rollouts_torch_zoo(env, params, u, device=dev)))
    for card, cpu in zip(*runs):
        np.testing.assert_array_equal(card["actions"], cpu["actions"])
        for k in ("obs", "logp", "values", "rewards"):
            np.testing.assert_allclose(card[k], cpu[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_ppo_update_on_the_card_matches_cpu(cuda):
    """One minibatch update and one whole update phase on the card (float32,
    TF32 off) against the CPU at 1e-5."""
    from repro_torch.core.rl import ppo

    cfg = ppo.PPOConfig(entropy_coef=0.01)
    net = ppo.init_net(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(2)
    T, W = 120, 56
    buf = {"obs": rng.standard_normal((T, W, 16)).astype(np.float32),
           "actions": rng.integers(0, 108, (T, W)).astype(np.int32),
           "logp": (np.log(1 / 108) + 0.3 * rng.standard_normal((T, W))).astype(np.float32),
           "values": rng.standard_normal((T, W)).astype(np.float32),
           "rewards": rng.standard_normal((T, W)).astype(np.float32),
           "dones": np.eye(1, T, T - 1, dtype=np.float32)[0],
           "last_value": np.zeros(W, np.float32)}
    batch = {"obs": buf["obs"][0], "actions": buf["actions"][0].astype(np.int64),
             "logp_old": buf["logp"][0], "adv": buf["rewards"][0], "returns": buf["values"][0]}
    outs = []
    for dev in (cuda, "cpu"):
        p = ppo.params_from_jax(net, device=dev)
        one = ppo.ppo_update(p, ppo.init_opt_state(p),
                             {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}, cfg)
        phase = ppo.update_phase(p, ppo.init_opt_state(p), buf, cfg, 0, device=dev)
        outs.append((ppo.params_to_numpy(one[0]), float(one[2]),
                     ppo.params_to_numpy(phase[0]), phase[4]))
    (p1, l1, q1, m1), (p2, l2, q2, m2) = outs
    assert l1 == pytest.approx(l2, rel=1e-5, abs=1e-5)
    np.testing.assert_allclose(m1, m2, rtol=1e-5, atol=1e-5)
    for a, b in ((p1, p2), (q1, q2)):
        for n in b:
            for k in b[n]:
                np.testing.assert_allclose(a[n][k], b[n][k], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{n}.{k}")


# ---------------------------------------------------------------------------
# Gradients through the kernels (kernels/ops.py's autograd Functions) and
# training on the card.
# ---------------------------------------------------------------------------
FLASH_GRAD_CASES = [
    # b, sq, sk, nq, nkv, causal, window
    (2, 100, 100, 4, 4, True, 0),       # causal
    (1, 130, 130, 4, 2, True, 32),      # windowed (GQA)
    (2, 20, 70, 4, 4, False, 0),        # non-causal (cross-attention)
    (1, 96, 96, 8, 2, True, 0),         # GQA 4:1
]


def _leaves(*xs):
    return [x.clone().requires_grad_() for x in xs]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_function_forward_is_the_kernel_backward_the_plain_vjp(cuda, case, hd, dtype):
    """``ops.flash_attention`` on CUDA tensors that require grad: one kernel
    launch whose output is within the kernel tolerance of the plain
    version, and gradients of q, k and v equal to autograd of the plain
    version on the same inputs (the backward is that VJP)."""
    b, sq, sk, nq, nkv, causal, window = case
    q, k, v, g = _randn(hd, (b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd),
                        (b, sq, nq, hd), dtype=DTYPES[dtype], device=cuda)
    launches = fa.launches
    leaves = _leaves(q, k, v)
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    assert fa.launches == launches + 1 and out.requires_grad
    got = torch.autograd.grad(out, leaves, g)
    plain = _leaves(q, k, v)
    want_out = ref.mha_reference(*plain, causal=causal, window=window)
    want = torch.autograd.grad(want_out, plain, g)
    assert fa.launches == launches + 1                  # the backward launches no kernel
    assert _err(out, want_out) < TOL[dtype]
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert bool(torch.isfinite(a.float()).all()) and bool(a.abs().max() > 0)
        assert _err(a, w) <= 1e-6 * max(1.0, float(w.float().abs().max()))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_function_forward_is_the_kernel_backward_the_plain_vjp(cuda, with_state, dtype):
    r, k, v, w, u, s0 = _rwkv_inputs((2, 45, 4, 64, with_state), DTYPES[dtype], cuda)
    g_out, g_s = _randn(7, (2, 45, 4, 64), (2, 4, 64, 64), dtype=torch.float32, device=cuda)
    g_out = g_out.to(DTYPES[dtype])
    inputs = [r, k, v, w, u] + ([s0] if with_state else [])
    launches = rk.launches
    leaves = _leaves(*inputs)
    out, s = ops.rwkv6(*leaves)
    assert rk.launches == launches + 1 and out.requires_grad and s.requires_grad
    got = torch.autograd.grad((out, s), leaves, (g_out, g_s))
    plain = _leaves(*inputs)
    want_out, want_s = ref.rwkv6_reference(*plain)
    want = torch.autograd.grad((want_out, want_s), plain, (g_out, g_s))
    assert rk.launches == launches + 1
    assert _err(out, want_out) < RWKV_TOL[dtype] and _err(s, want_s) < RWKV_TOL[dtype]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and bool(a.abs().max() > 0)
        assert _err(a, b) <= 1e-6 * max(1.0, float(b.float().abs().max()))


def test_kernels_without_a_function_refuse_a_gradient(cuda):
    """The decode wrapper (and the scan writing a cache in place, and each
    wrapper called directly) raises when grad mode is on and an input
    requires a gradient, instead of returning an output with no history."""
    q, kc, vc = _randn(0, (2, 4, 64), (2, 32, 4, 64), (2, 32, 4, 64),
                       dtype=torch.float32, device=cuda)
    valid = torch.ones((2, 32), dtype=torch.bool, device=cuda)
    qg = q.clone().requires_grad_()
    for fn in (da.decode_attention, ops.decode_attention):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(qg, kc, vc, valid)
    with torch.no_grad():
        torch.testing.assert_close(ops.decode_attention(qg, kc, vc, valid),
                                   ops.decode_attention(q, kc, vc, valid))
    x = _randn(1, (1, 8, 2, 64), dtype=torch.float32, device=cuda)[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(x, x, x)
    r, k, v, w, u, s0 = _rwkv_inputs((1, 8, 2, 64, True), torch.float32, cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        rk.rwkv6_scan(r.requires_grad_(), k, v, w, u, s0)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv6(r, k, v, w, u, s0, final_state=s0)


def test_rwkv6_kernel_f32_strong_decay_at_the_served_shape(cuda):
    """The f32 cluster kernel (which training runs) under strong decay,
    exp(-exp(U(-2, 4))) down to 1e-24, at rwkv6-1.6b's served prefill
    (T = 500, H = 32, hd 64: the plan's runs of several chunks), within
    1e-4 of the plain version."""
    r, k, v, w, u, s0 = _rwkv_inputs((1, 500, 32, 64, True), torch.float32, cuda, strong=True)
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s_t).all())
    assert _err(out, exp_o) < 1e-4 and _err(s_t, exp_s) < 1e-4


# the cluster kernel's plans (b, t, h, hd): the served prefill, T = 2048, a
# ragged 19 chunks, the training forward, and every head dim over a cluster
RWKV_CLUSTER_CASES = [(1, 500, 32, 64), (1, 2048, 4, 64), (2, 600, 3, 64), (4, 128, 32, 64),
                      (2, 200, 3, 16), (2, 200, 3, 32), (2, 200, 3, 128), (1, 600, 2, 128)]


@pytest.mark.parametrize("case", RWKV_CLUSTER_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_cluster_kernel_plans(cuda, case, dtype):
    """The cluster kernel at each plan against the plain version (r, k, v
    halved as the edge cases are, |o| below bf16's step of 8), one launch a
    call; where some rank count's clusters fit the card in one wave, the
    wrapper's plan takes one wave and no such count has shorter runs."""
    b, t, h, hd = case
    dt, nc = DTYPES[dtype], -(-t // 32)
    plan = rk.plan_on(b, t, h, hd, dt, cuda)
    one_wave = [r for r in range(1, min(nc, 16) + 1)
                if rk.max_active_clusters(dt, hd, r, cuda, r == nc) >= b * h]
    if one_wave:
        assert plan.waves == 1 and -(-nc // plan.ranks) == min(-(-nc // r) for r in one_wave)
    r, k, v, w, u, s0 = _rwkv_inputs((*case, True), dt, cuda, scale=0.5)
    launches = rk.launches
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert rk.launches == launches + 1
    assert _err(out, exp_o) < RWKV_TOL[dtype] and _err(s_t, exp_s) < RWKV_TOL[dtype]


@pytest.mark.parametrize("ranks", range(1, 17))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_cluster_kernel_every_rank_count(cuda, monkeypatch, ranks, dtype):
    """17 chunks (a ragged last one of 8 tokens) over every rank count the
    card holds a cluster of, whatever the plan would take: ragged runs,
    every carry share, the state also updated in place (bit-equal)."""
    b, t, h, hd = 2, 520, 3, 64
    dt = DTYPES[dtype]
    if rk.max_active_clusters(dt, hd, ranks, cuda, False) < 1:
        pytest.skip(f"the card holds no cluster of {ranks}")
    forced = rk.ClusterPlan(ranks, 17, tuple(ref.rwkv6_rank_runs(17, ranks)), (ranks, h, b), 1, 1)
    monkeypatch.setattr(rk, "plan_on", lambda *args: forced)
    r, k, v, w, u, s0 = _rwkv_inputs((b, t, h, hd, True), dt, cuda, scale=0.5)
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert _err(out, exp_o) < RWKV_TOL[dtype] and _err(s_t, exp_s) < RWKV_TOL[dtype]
    state = s0.clone()
    out_in, _ = rk.rwkv6_scan(r, k, v, w, u, state, final_state=state)
    assert torch.equal(out_in, out) and torch.equal(state, s_t)


@pytest.mark.parametrize("t", [500, 600])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_cluster_kernel_updates_the_state_in_place(cuda, t, dtype):
    """``final_state=state`` at T > 32 through the wrapper's plans (B = 2,
    H = 4: one wave of one chunk a rank at T = 500, rank 0 reading s0 for
    its outputs before the first cluster barrier; several at T = 600), each
    element of the state read and then written by its owner: the result of
    a separate final state, bit for bit, within tolerance of the plain
    version."""
    r, k, v, w, u, s0 = _rwkv_inputs((2, t, 4, 64, True), DTYPES[dtype], cuda, scale=0.5)
    out_sep, s_sep = rk.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    out_in, s_in = rk.rwkv6_scan(r, k, v, w, u, state, final_state=state)
    assert s_in is state
    assert torch.equal(out_in, out_sep) and torch.equal(state, s_sep)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert _err(out_in, exp_o) < RWKV_TOL[dtype] and _err(state, exp_s) < RWKV_TOL[dtype]


@pytest.mark.parametrize("t", [517, 45])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_cluster_kernel_ragged_last_chunk_strong_decay(cuda, t, dtype):
    """A last chunk of 5 and of 13 tokens under strong decay: TMA fills its
    rows past T with w = 0, which the kernel must read as w = 1 (else the
    final state decays to 0)."""
    r, k, v, w, u, s0 = _rwkv_inputs((1, t, 4, 64, True), DTYPES[dtype], cuda, strong=True,
                                     scale=0.5)
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, s0)
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())
    assert _err(out, exp_o) < RWKV_TOL[dtype] and _err(s_t, exp_s) < RWKV_TOL[dtype]
    assert float(s_t.abs().max()) > 1e-3


def _grads_and_step(cfg, params, batch, device):
    from repro_torch.training import OptimizerConfig, ScheduleConfig, adamw_init
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = model.loss_fn(cfg, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3),
                       schedule=ScheduleConfig(kind="constant", peak_lr=1e-3, warmup_steps=1))
    new, opt, metrics = make_train_step(cfg, tcfg)(params, adamw_init(params, tcfg.optimizer),
                                                   batch)
    return float(loss), grads, metrics, new, opt


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-small"])
def test_train_step_on_the_card_matches_cpu(cuda, arch):
    """``loss_fn``'s gradients and one ``make_train_step`` at ``reduced()``
    in f32, on the card (kernel forwards, plain backwards) against the CPU
    (plain versions): loss and grad_norm at 1e-4 relative, every gradient
    leaf, m and v at 1e-3 of the leaf's largest value (``chip_smoke.py``
    phase 6b's tolerances), every gradient leaf finite and non-zero, and the
    step through the kernels (every attention layer's flash call, every
    RWKV layer's scan, twice with remat)."""
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import batch_to

    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = frontends.audio_frames(cfg, 2, seed=3)
    before = (fa.launches, rk.launches)
    card = _grads_and_step(cfg, _to(params, cuda), batch_to(batch, cuda), cuda)
    kinds = cfg.layer_kinds()
    n_attn = sum(kd in ("attn", "local") for kd in kinds)
    if cfg.is_encoder_decoder:
        n_attn += cfg.encoder_layers + cfg.num_layers       # encoder, cross-attention
    # loss_fn once (remat: the forward and its recompute), then the step again
    assert fa.launches - before[0] == 2 * 2 * n_attn
    assert rk.launches - before[1] == 2 * 2 * kinds.count("rwkv")
    cpu = _grads_and_step(cfg, params, batch_to(batch, "cpu"), "cpu")
    assert card[0] == pytest.approx(cpu[0], rel=1e-4)
    assert float(card[2]["grad_norm"]) == pytest.approx(float(cpu[2]["grad_norm"]), rel=1e-4)
    for a, b in zip(card[1], cpu[1]):
        assert a is not None and bool(torch.isfinite(a).all()) and bool(a.abs().max() > 0)
        assert _err(a.cpu(), b) <= 1e-3 * float(b.abs().max())
    for tree in ("m", "v"):
        for a, b in zip(tree_leaves(card[4][tree]), tree_leaves(cpu[4][tree])):
            assert _err(a.cpu(), b) <= 1e-3 * float(b.abs().max())


# ---------------------------------------------------------------------------
# The specs' steps (launch/specs.py) on the card.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "kimi-k2-1t-a32b", "whisper-small"])
def test_spec_steps_on_the_card_equal_direct_calls(cuda, arch, kind):
    """``build_step``'s step at ``reduced()`` on tensors made on the card
    from its meta specs equals a direct call of the model's entry point bit
    for bit, and the dry-run's parameter bytes are the tensors'."""
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptimizerConfig, adamw_init, tree_leaves

    cfg = get_config(arch).reduced()
    shape = InputShape(kind, 48, 2, kind)
    step, args, _, _, _ = specs.build_step(cfg, shape, make_production_mesh())
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init_params(cfg, gen, dtype=args[0]["embed"].dtype, device=cuda)
    assert (sum(t.numel() * t.element_size() for t in tree_leaves(params))
            == dryrun.record(cfg, shape)["bytes"]["params"])
    ints = lambda *sh: torch.randint(0, cfg.vocab_size, sh, generator=gen, device=cuda,
                                     dtype=torch.int32)
    extra = [torch.randn(a.shape, generator=gen, device=cuda).to(a.dtype) for a in args[3:]]
    if kind == "train":
        batch = {"inputs": ints(2, 48), "labels": ints(2, 48)}
        if cfg.is_encoder_decoder:
            enc = args[2]["enc_inputs"]
            batch["enc_inputs"] = torch.randn(enc.shape, generator=gen, device=cuda).to(enc.dtype)
        tcfg = train_loop.TrainConfig(moe_path="ep_a2a" if cfg.num_experts else "local",
                                      optimizer=OptimizerConfig(state_dtype=torch.float32))
        opt = adamw_init(params, tcfg.optimizer)
        got, exp = step(params, opt, batch), train_loop.make_train_step(cfg, tcfg)(params, opt, batch)
    else:
        caches = [model.init_cache(cfg, 2, 48, dtype=params["embed"].dtype, device=cuda)
                  for _ in range(2)]
        if kind == "prefill":
            tokens = ints(2, 48)
            got = step(params, tokens, caches[0], *extra)
            exp = model.prefill(cfg, params, tokens, caches[1],
                                enc_inputs=extra[0] if extra else None,
                                moe_path="ep_a2a" if cfg.num_experts else "local")
        else:
            tokens = ints(2)
            if cfg.is_encoder_decoder:      # a decode step reads the cross K/V prefill stores
                for c in caches:
                    c["cross"] = {k: torch.zeros(v.shape, dtype=v.dtype, device=cuda)
                                  for k, v in args[2]["cross"].items()}
            got, exp = step(params, tokens, caches[0]), model.decode_step(cfg, params, tokens,
                                                                          caches[1])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(exp)))
