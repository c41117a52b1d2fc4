"""The schedule of the bf16 flash kernel, held on the CPU.

``ref.flash_tile_plan`` is the tile walk of ``csrc/flash_attention.cu``'s
``fa_wgmma_kernel`` (row blocks of 128 query rows, or a consumer's 64, the
whole block at hd 256 (``ref.flash_bf16_tiles``), KV tiles of 64 keys:
which tiles a block skips, runs unmasked or masks; ``fa_tf32_kernel``'s
64 x 32 at hd 112 and 128 too),
and ``ref.flash_tiled_reference`` its arithmetic in plain PyTorch (online
softmax in log2 units, P V from P's bf16 high and low parts).  The plan is
held to the dense mask of ``ref.mha_reference``; the function to the JAX
package's Pallas kernel in interpret mode at block_q = block_k = 128 and to
``ref.mha_reference``, at the tolerances of ``tests/test_kernels.py`` (2e-5
in f32, 2e-2 in bf16), and in bf16 within half a bf16 step of the f32
attention of the same inputs where outputs reach |o| ~ 27, which is what a
kernel that computes in f32 and rounds once meets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EDGES = (1, 127, 128, 129, 1500)
# causal, window, q_offset: non-causal, causal, a window with a q_offset
# inside the first tile, a window whose edge and q_offset cross tile edges
MASKS = {"full": (False, 0, 0), "causal": (True, 0, 0), "window": (True, 48, 37),
         "window_across_tiles": (True, 200, 70)}


def _inputs(case, dtype, seed):
    b, sq, sk, nq, nkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd))]
    jd, td = DTYPES[dtype]
    return [jnp.asarray(x, jd) for x in xs], [torch.from_numpy(x).to(td) for x in xs]


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("sq", EDGES)
@pytest.mark.parametrize("sk", EDGES)
@pytest.mark.parametrize("mask", list(MASKS))
def test_tile_classes_match_the_dense_mask(sq, sk, mask):
    causal, window, q_offset = MASKS[mask]
    dense = ref.attention_mask(sq, sk, causal=causal, window=window, q_offset=q_offset).numpy()
    # the bf16 kernel's blocks below hd 256 and at hd 256 (a consumer's
    # rows), and the f32 kernel's at hd 112 and 128
    for bm, bn in (ref.flash_bf16_tiles(128), ref.flash_bf16_tiles(256),
                   ref.flash_tf32_tiles(128)):
        plan = ref.flash_tile_plan(sq, sk, causal=causal, window=window, q_offset=q_offset,
                                   bm=bm, bn=bn)
        assert plan.shape == (-(-sq // bm), -(-sk // bn))
        for r in range(plan.shape[0]):
            for t in range(plan.shape[1]):
                block = dense[r * bm:(r + 1) * bm, t * bn:(t + 1) * bn]
                whole = block.shape[1] == bn
                if plan[r, t] == ref.TILE_SKIPPED:
                    assert not block.any(), (bm, r, t)
                elif plan[r, t] == ref.TILE_INTERIOR:
                    assert whole and block.all(), (bm, r, t)
                else:
                    # a masked tile holds a hidden pair or runs past Sk
                    assert not (whole and block.all()), (bm, r, t)
        # the walk of a block is one run of tiles from the window edge
        for row in plan:
            walked = np.flatnonzero(row != ref.TILE_SKIPPED)
            assert walked.size == 0 or np.array_equal(walked, np.arange(walked[0], walked[-1] + 1))


# b, sq, sk, nq, nkv, hd, causal, window, q_offset: the tile edges in Sq
# and Sk, GQA at 4:1 and 2:2, hd 16 to 128 (112 is kimi-k2's), windows
# whose edges and offsets cross tile edges; hd 256 at 16:1
# (recurrentgemma-9b's) across its 64-row blocks and 64-key tiles
CASES = [
    (1, 1, 1, 2, 2, 64, True, 0, 0),
    (1, 127, 127, 4, 1, 64, True, 0, 0),
    (2, 128, 128, 4, 2, 32, True, 0, 0),
    (1, 129, 129, 2, 2, 128, True, 0, 0),
    (1, 129, 127, 2, 1, 16, False, 0, 0),
    (2, 1, 129, 4, 1, 112, False, 0, 0),
    (1, 4, 300, 4, 2, 112, False, 0, 0),
    (1, 129, 300, 4, 4, 64, True, 48, 37),
    (1, 200, 300, 2, 1, 64, True, 100, 70),
    (1, 64, 200, 2, 2, 32, True, 8, 150),
    (1, 129, 127, 16, 1, 256, True, 0, 0),
    (1, 65, 200, 16, 1, 256, False, 0, 0),
    (1, 100, 300, 16, 1, 256, True, 64, 150),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_reference_matches_pallas_interpret(case, dtype):
    causal, window, q_offset = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype, seed=sum(case))
    exp = pallas_flash(jq, jk, jv, causal=causal, window=window, q_offset=q_offset,
                       block_q=128, block_k=128, interpret=True)
    out = ref.flash_tiled_reference(tq, tk, tv, causal=causal, window=window, q_offset=q_offset)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    exp = torch.from_numpy(np.array(exp.astype(jnp.float32)))
    assert _err(exp, out) < TOL[dtype]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_reference_matches_mha_reference(case, dtype):
    causal, window, q_offset = case[6:]
    _, (tq, tk, tv) = _inputs(case, dtype, seed=sum(case) + 1)
    out = ref.flash_tiled_reference(tq, tk, tv, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(tq, tk, tv, causal=causal, window=window, q_offset=q_offset)
    dense = ref.attention_mask(tq.shape[1], tk.shape[1], causal=causal, window=window,
                               q_offset=q_offset)
    # a row with no visible key gives 0 (the plain version spreads its
    # softmax over the masked keys instead)
    seen = dense.any(dim=1)[None, :, None, None]
    assert _err(torch.where(seen, exp.float(), torch.zeros_like(exp.float())), out) < TOL[dtype]
    assert not bool(out.float()[:, ~dense.any(dim=1)].any())


@pytest.mark.parametrize("hd", [64, 112, 128, 256])
def test_bf16_within_half_a_step_of_f32_at_large_outputs(hd):
    q, k, v = ref.large_output_inputs(hd, "cpu")
    out = ref.flash_tiled_reference(q, k, v, causal=True)
    o32 = ref.mha_reference(q.float(), k.float(), v.float(), causal=True)
    assert float(o32.abs().max()) >= 16.0
    steps = ref.bf16_steps_from_f32(out, q, k, v, causal=True)
    assert float(steps.max()) <= 0.5 + 2 ** -6
