"""Split-S flash decode on the CPU: the plain split-and-combine version and
the wrapper's split plan.

``ref.decode_attention_split_reference`` computes the partials and the
combine of ``csrc/decode_attention.cu``; it is held to the JAX oracle
``repro.kernels.ref.decode_attention_reference`` on the same numpy inputs
from a seed.  Tolerance 1e-5 in f32: the same f32 softmax with the sums
taken split by split, rounding of ~1e-7 relative on outputs of size ~1;
2e-2 in bf16, as ``tests/test_kernels.py`` (one bf16 rounding of the
output; the split version keeps the probabilities in f32 where the oracle
rounds them to bf16).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ref

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

SHAPES = [
    # b, s, nq, nkv, hd
    (2, 150, 4, 4, 16),      # MHA, ragged S
    (3, 333, 8, 2, 32),      # GQA groups of 4
    (2, 256, 8, 1, 64),      # MQA
]
SPLITS = [1, 2, 3, 7]


def _mask(kind, b, s, rng):
    """(b, s) bool.  Every sequence keeps at least one valid slot."""
    if kind == "random":
        valid = rng.uniform(size=(b, s)) < 0.7
    elif kind == "prefix":
        valid = np.arange(s)[None, :] < rng.integers(1, s + 1, size=(b, 1))
    elif kind == "ring_holes":               # holes of 20-90 slots in the middle
        valid = np.ones((b, s), dtype=bool)
        for i in range(b):
            for _ in range(3):
                lo = int(rng.integers(1, s - 1))
                valid[i, lo:lo + int(rng.integers(20, 91))] = False
    elif kind == "ends_only":                # every middle split wholly invalid
        valid = np.zeros((b, s), dtype=bool)
        valid[:, :5] = True
        valid[:, -3:] = True
    else:
        raise ValueError(kind)
    valid[np.arange(b), rng.integers(0, s, size=b)] = True
    return valid


def _inputs(b, s, nq, nkv, hd, kind, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)))
    valid = _mask(kind, b, s, rng)
    jd, td = DTYPES[dtype]
    jax_in = [jnp.asarray(x, jd) for x in (q, k, v)] + [jnp.asarray(valid)]
    torch_in = [torch.from_numpy(x).to(td) for x in (q, k, v)] + [torch.from_numpy(valid)]
    return jax_in, torch_in


def _err(j_out, t_out) -> float:
    return float(np.max(np.abs(np.asarray(j_out.astype(jnp.float32)) - t_out.float().numpy())))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("kind", ["random", "prefix", "ring_holes", "ends_only"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_reference_matches_jax(shape, kind, splits):
    jx, tx = _inputs(*shape, kind, seed=sum(shape) + splits + len(kind))
    exp = jref.decode_attention_reference(*jx)
    out = ref.decode_attention_split_reference(*tx, splits)
    assert out.shape == tx[0].shape and out.dtype == torch.float32
    assert _err(exp, out) < TOL["float32"]


@pytest.mark.parametrize("splits", [2, 7])
def test_split_reference_matches_jax_bf16(splits):
    jx, tx = _inputs(2, 300, 8, 2, 64, "ring_holes", seed=splits, dtype="bfloat16")
    out = ref.decode_attention_split_reference(*tx, splits)
    assert out.dtype == torch.bfloat16
    assert _err(jref.decode_attention_reference(*jx), out) < TOL["bfloat16"]


@pytest.mark.parametrize("b,nkv,s,sm", [(8, 16, 2048, 132), (8, 8, 4096, 132),
                                         (1, 2, 1000, 132), (2, 4, 333, 78)])
def test_split_reference_on_the_kernels_plan(b, nkv, s, sm):
    """The ranges the wrapper gives the kernel (chunk a multiple of 64, the
    last split to S), with the main path's prefix masks and with holes."""
    splits, chunk = da.split_plan(b, nkv, s, sm)
    assert splits > 1
    for kind in ("prefix", "ring_holes"):
        jx, tx = _inputs(b, s, 2 * nkv, nkv, 16, kind, seed=s + splits)
        out = ref.decode_attention_split_reference(*tx, splits, chunk)
        assert _err(jref.decode_attention_reference(*jx), out) < TOL["float32"]


@pytest.mark.parametrize("splits", SPLITS)
def test_split_reference_empty_sequence_gives_zero(splits):
    """A sequence with no valid slot gives 0, as the kernels do (the oracle
    spreads its softmax over the masked slots instead); the others of the
    batch are unaffected."""
    jx, tx = _inputs(3, 200, 4, 2, 32, "random", seed=splits)
    tx[3][1] = False
    out = ref.decode_attention_split_reference(*tx, splits)
    assert not bool(out[1].any())
    exp = jref.decode_attention_reference(*jx[:3], jnp.asarray(tx[3].numpy()))
    keep = [0, 2]
    assert _err(exp[np.array(keep)], out[keep]) < TOL["float32"]


def test_split_reference_single_valid_slot_in_last_split():
    q, k, v = (torch.from_numpy(np.random.default_rng(4).standard_normal(sh).astype(np.float32))
               for sh in ((1, 4, 16), (1, 130, 2, 16), (1, 130, 2, 16)))
    valid = torch.zeros((1, 130), dtype=torch.bool)
    valid[0, 129] = True
    out = ref.decode_attention_split_reference(q, k, v, valid, 3)
    assert float((out[0] - v[0, 129].repeat_interleave(2, dim=0)).abs().max()) < 1e-6


def test_split_reference_refuses_a_bad_cut():
    q, k = torch.zeros((1, 2, 16)), torch.zeros((1, 10, 2, 16))
    valid = torch.ones((1, 10), dtype=torch.bool)
    with pytest.raises(ValueError, match="cut"):
        ref.decode_attention_split_reference(q, k, k, valid, 11)
    with pytest.raises(ValueError, match="cut"):
        ref.decode_attention_split_reference(q, k, k, valid, 3, chunk=5)


PLAN_SHAPES = [
    # b, nkv, s
    (8, 16, 2048),    # qwen1.5-0.5b decode, 8 slots
    (8, 8, 4096),     # llama3-8b decode
    (1, 2, 1000),
    (1, 1, 1),
    (2, 4, 63),
    (4, 8, 129),
    (3, 5, 700),
    (33, 8, 4096),    # b * nkv = 264 = 2 x 132
    (64, 8, 4096),
]


@pytest.mark.parametrize("sm", [132, 114, 78])
@pytest.mark.parametrize("b,nkv,s", PLAN_SHAPES)
def test_split_plan_covers_every_slot_once(b, nkv, s, sm):
    splits, chunk = da.split_plan(b, nkv, s, sm)
    ranges = ref.split_ranges(s, splits, chunk)
    assert len(ranges) == splits >= 1
    covered = np.zeros(s, dtype=int)
    for lo, hi in ranges:
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if splits > 1:
        assert chunk % da.MIN_SPLIT_SLOTS == 0
        assert all(hi - lo >= da.MIN_SPLIT_SLOTS for lo, hi in ranges)
        # no more CTAs than the aim needs
        assert b * nkv * (splits - 1) < da.CTAS_PER_SM * sm
    if b * nkv >= da.CTAS_PER_SM * sm:
        assert (splits, chunk) == (1, s)


@pytest.mark.parametrize("b,nkv,s,expected", [
    (8, 16, 2048, (3, 704)),     # 128 CTAs -> 384 on 132 SMs
    (8, 8, 4096, (5, 832)),      # 64 -> 320
    (33, 8, 4096, (1, 4096)),    # 264 CTAs: 2 per SM already
    (1, 1, 100, (1, 100)),       # fewer than two tiles: one split
])
def test_split_plan_on_the_h100(b, nkv, s, expected):
    assert da.split_plan(b, nkv, s, 132) == expected
