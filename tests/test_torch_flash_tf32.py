"""The arithmetic of the f32 flash kernel, held on the CPU.

``csrc/flash_attention.cu``'s f32 kernel at hd <= 128 computes each f32
product on the tensor cores as three tf32 products (big.big + big.small +
small.big, big = the top 19 bits of the f32, small = the remainder, both
read truncated), each wgmma's sum added to the accumulators rounded toward
zero. At hd 256 two CTAs of a cluster split the head dims, each computing
the partial S over its 128 of them, and S is the two partials added in f32.
``ref.flash_tf32_reference`` is that arithmetic on the kernel's tile
walk and tiles (``ref.flash_tf32_tiles``, ``ref.flash_tf32_cluster``). It is held to the
JAX package's Pallas kernel in interpret mode and to ``ref.mha_reference``
at the f32 tolerance of ``tests/test_kernels.py`` (2e-5); one tf32 product
must miss that tolerance (the test has teeth); and where outputs reach
|o| ~ 27, at which no f32 kernel meets 2e-5 against the plain version, it
stays as close to a float64 attention as the plain f32 version does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ref

TOL = 2e-5
EDGES = (1, 127, 128, 129, 1500)
# causal, window, q_offset (tests/test_torch_flash_tiles.py's MASKS)
MASKS = {"full": (False, 0, 0), "causal": (True, 0, 0), "window": (True, 48, 37),
         "window_across_tiles": (True, 200, 70)}


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is a loop of small products: one thread each, since
    threads of parallel test workers fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def test_tf32_keeps_the_top_19_bits():
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -11 + 2 ** -12, -(1 + 3 * 2 ** -12),
                      3.0, 0.0])
    assert ref.tf32(x).tolist() == [1 + 2 ** -10, 1.0, 1.0, -1.0, 3.0, 0.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    big = ref.tf32(y)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert float(((y - big) / y).abs().max()) < 2 ** -10
    # three products are within twice the f32 product's own rounding of a
    # float64 product, one is a thousand times further
    a, b = (torch.from_numpy(m) for m in _inputs(((64, 64), (64, 64)), 1))
    exact = a.double() @ b.double()
    f32 = _err(a @ b, exact)
    assert _err(ref.tf32_product(a, b, accumulate="exact"), exact) < 2 * f32
    assert _err(ref.tf32_product(a, b), exact) < 4 * f32
    assert _err(ref.tf32_product(a, b, products=1), exact) > 1000 * f32


def test_truncating_accumulation_rounds_toward_zero():
    """The tensor cores' model: each 8-wide step's exact sum is added to the
    accumulator and the result rounded toward zero to f32."""
    one = torch.ones(1, 1)
    a = torch.full((1, 8), 2.0 ** -14)
    b = torch.full((8, 1), 2.0 ** -15)                 # a @ b = 2^-26, 1/4 ulp of 1.0 below it
    for sign in (1.0, -1.0):
        got = ref.tf32_product(a, sign * b, sign * one, products=1)
        assert float(got) == sign * 1.0                # the step is dropped, not rounded up
        got = ref.tf32_product(a, -sign * b, sign * one, products=1)
        assert float(got) == sign * (1.0 - 2.0 ** -24)  # one ulp toward zero
        got = ref.tf32_product(a, -sign * b, sign * one, products=1, accumulate="exact")
        assert float(got) == sign * 1.0                # f32's own sum rounds to nearest


def test_attention_f64_is_the_plain_attention():
    """The float64 bar agrees with ``ref.mha_reference`` where f32 is
    accurate (GQA 4:2)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(((1, 100, 4, 32), (1, 100, 2, 32),
                                                    (1, 100, 2, 32)), seed=3))
    for causal in (True, False):
        o64 = ref.attention_f64(q, k, v, causal=causal)
        assert o64.dtype == torch.float64
        assert _err(ref.mha_reference(q, k, v, causal=causal), o64) < 1e-5


# every pair of edges at hd 64 (128 x 64 tiles: 4 q heads over 2 kv heads)
# and at hd 112 and 128 (64 x 32 tiles, four times the tile steps to
# emulate: 2 q heads over 1 kv head); at hd 256 (64 x 32 tiles a CTA of a
# cluster of two) the edges of those tiles, 63/65 rows and 31/33 keys
EDGES_HD256 = ((63, 31), (63, 33), (65, 31), (65, 33), (63, 63), (65, 65), (33, 65), (31, 63))
SWEEP = ([(hd, sq, sk) for hd in (64, 112, 128) for sq in EDGES for sk in EDGES]
         + [(256, sq, sk) for sq, sk in EDGES_HD256])
HEADS = {64: (4, 2), 112: (2, 1), 128: (2, 1), 256: (2, 1)}


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
def test_tf32_plan(hd):
    """Tiles and cluster of the f32 kernel: 128 x 64 up to hd 64, 64 x 32
    above; at hd 256 two CTAs of 128 dims each, one CTA below."""
    assert ref.flash_tf32_tiles(hd) == ((128, 64) if hd <= 64 else (64, 32))
    assert ref.flash_tf32_cluster(hd) == (2 if hd == 256 else 1)


def test_hd256_s_is_the_sum_of_two_partials():
    """At hd 256 the model's S is tf32_product over dims [0, 128) plus
    tf32_product over [128, 256), added in f32; it is not the product over
    all 256 dims in one sum (which truncates differently), so the split is
    what the model computes."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(((1, 64, 1, 256), (1, 32, 1, 256),
                                                    (1, 32, 1, 256)), seed=11))
    qh, kh = q[0, :, 0], k[0, :, 0]
    split = (ref.tf32_product(qh[:, :128], kh[:, :128].T)
             + ref.tf32_product(qh[:, 128:], kh[:, 128:].T))
    whole = ref.tf32_product(qh, kh.T)
    assert not torch.equal(split, whole)
    seen = []
    product = ref.tf32_product

    def spy(a, b, c=None, **kw):
        out = product(a, b, c, **kw)
        if c is None and a.shape[-1] == 128:
            seen.append(out)
        return out

    ref.tf32_product = spy
    try:
        ref.flash_tf32_reference(q, k, v, causal=False)
    finally:
        ref.tf32_product = product
    assert len(seen) == 2 and torch.equal((seen[0] + seen[1])[0, 0], split)


def _pallas_case(hd, sq, sk, mask):
    """Inputs of one sweep case and the Pallas kernel's output on them."""
    causal, window, q_offset = MASKS[mask]
    nq, nkv = HEADS[hd]
    xs = _inputs(((1, sq, nq, hd), (1, sk, nkv, hd), (1, sk, nkv, hd)), seed=sq * 7 + sk + hd)
    exp = pallas_flash(*(jnp.asarray(x) for x in xs), causal=causal, window=window,
                       q_offset=q_offset, block_q=128, block_k=128, interpret=True)
    return [torch.from_numpy(x) for x in xs], torch.from_numpy(np.array(exp))


@pytest.mark.parametrize("hd,sq,sk", SWEEP)
@pytest.mark.parametrize("mask", list(MASKS))
def test_tf32_emulation_matches_pallas_interpret(hd, sq, sk, mask):
    (q, k, v), exp = _pallas_case(hd, sq, sk, mask)
    causal, window, q_offset = MASKS[mask]
    # sums in f32 (the truncating model costs ~20 s at S = 1500; it is held
    # to the Pallas kernel at one ragged pair a tile plan below)
    out = ref.flash_tf32_reference(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   accumulate="exact")
    assert out.shape == q.shape and out.dtype == torch.float32
    assert _err(exp, out) < TOL


@pytest.mark.parametrize("hd,sq,sk", [(64, 129, 127), (128, 127, 129), (256, 65, 33)])
@pytest.mark.parametrize("mask", list(MASKS))
def test_truncating_tf32_emulation_matches_pallas_interpret(hd, sq, sk, mask):
    """The kernel's own arithmetic (the tensor cores' truncating sums, small
    products first) at a ragged pair of each tile plan: a partial last row
    block and a partial last KV tile."""
    (q, k, v), exp = _pallas_case(hd, sq, sk, mask)
    causal, window, q_offset = MASKS[mask]
    out = ref.flash_tf32_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert _err(exp, out) < TOL


def _training_width():
    """B=2, S=512, 16 heads of 64, causal: the training shape at batch 2."""
    return [torch.from_numpy(x) for x in _inputs([(2, 512, 16, 64)] * 3, seed=0)]


def test_tf32_emulation_matches_mha_reference_at_the_training_width():
    q, k, v = _training_width()
    out = ref.flash_tf32_reference(q, k, v, causal=True)
    assert _err(out, ref.mha_reference(q, k, v, causal=True)) < TOL


def test_one_tf32_product_misses_the_f32_tolerance():
    q, k, v = _training_width()
    out = ref.flash_tf32_reference(q, k, v, causal=True, products=1)
    assert _err(out, ref.mha_reference(q, k, v, causal=True)) > 20 * TOL


@pytest.mark.parametrize("hd", [64, 112, 128, 256])
def test_tf32_as_close_to_float64_as_plain_f32_at_large_outputs(hd):
    q, k, v = ref.large_output_inputs(hd, "cpu", torch.float32)
    o64 = ref.attention_f64(q, k, v, causal=True)
    assert float(o64.abs().max()) >= 16.0
    plain = _err(ref.mha_reference(q, k, v, causal=True), o64)
    assert _err(ref.flash_tf32_reference(q, k, v, causal=True), o64) <= 1.5 * plain
