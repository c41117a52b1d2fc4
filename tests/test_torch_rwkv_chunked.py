"""The chunk-parallel RWKV-6 scan on the CPU: its plain version against the
JAX oracle, and the kernel wrapper's cluster plan.

``ref.rwkv6_chunk_parallel_reference`` computes the chunk-parallel form of
``csrc/rwkv6_scan.cu`` in f32 products (what the dry-run counts): 32-token
chunks split into two 16-token sub-chunks, pairwise scores inside a
sub-chunk, the off-diagonal block factored at the sub-chunk edge,
per-chunk state increments, the serial carry and the carry-in term
(``tests/test_torch_rwkv_cluster.py`` holds the kernel's own schedule and
tf32 products).  It is held to the sequential JAX oracle
``repro.kernels.ref.rwkv6_reference`` on the same numpy inputs from a seed.
Tolerance 1e-5 in f32: the same f32 products summed in another order, and
the decays multiplied as 2^(a sum of log2 w) where the oracle multiplies them
one by one, on outputs of size ~10-30 (rounding of ~1e-7 relative); 5e-2 in
bf16, as ``tests/test_kernels.py`` (one bf16 rounding of the output).  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as rk

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RWKV_CASES = [
    # b, t, h, hd, chunk, with_state  (tests/test_kernels.py; the port's chunk is 32)
    (2, 64, 2, 32, 16, False),
    (1, 50, 4, 64, 32, True),     # ragged tail (t % chunk != 0)
    (2, 33, 1, 16, 8, True),
    (1, 128, 2, 64, 32, True),
]
# one token, one sub-chunk, one past it, one whole chunk, one past it, 64 chunks
LENGTHS = [1, 16, 17, 32, 33, 2048]


def _inputs(b, t, h, hd, with_state, seed, strong=False):
    """numpy inputs with the distribution of tests/test_kernels.py; strong:
    w = exp(-exp(U(-2, 4))), down to exp(-e^4) ~ 1e-24."""
    rng = np.random.default_rng(seed)
    x = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sh = (b, t, h, hd)
    if strong:
        w = np.exp(-np.exp(rng.uniform(-2.0, 4.0, sh))).astype(np.float32)
    else:
        w = (1 / (1 + np.exp(-(x(*sh) * 2 - 1))) * 0.5 + 0.45).astype(np.float32)
    s0 = x(b, h, hd, hd) * 0.2 if with_state else None
    return x(*sh) * 0.5, x(*sh) * 0.5, x(*sh), w, x(h, hd) * 0.3, s0


def _check(arrays, dtype):
    """The plain chunk-parallel version against the JAX oracle: out and final
    state within TOL, finite, of the right shape and dtype."""
    jd, td = DTYPES[dtype]
    r, k, v, w, u, s0 = arrays
    jx = [jnp.asarray(a, jd) for a in (r, k, v, w)] + [jnp.asarray(u)]
    tx = [torch.from_numpy(a).to(td) for a in (r, k, v, w)] + [torch.from_numpy(u)]
    jx.append(None if s0 is None else jnp.asarray(s0))
    tx.append(None if s0 is None else torch.from_numpy(s0))
    out, s_t = ref.rwkv6_chunk_parallel_reference(*tx)
    exp_o, exp_s = jref.rwkv6_reference(*jx)
    assert out.shape == tx[0].shape and out.dtype == td and s_t.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())
    err_o = float(np.max(np.abs(np.asarray(jnp.asarray(exp_o, jnp.float32)) - out.float().numpy())))
    err_s = float(np.max(np.abs(np.asarray(exp_s) - s_t.numpy())))
    assert err_o < TOL[dtype] and err_s < TOL[dtype], (err_o, err_s)


@pytest.mark.parametrize("case", RWKV_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunk_parallel_matches_jax_oracle(case, dtype):
    b, t, h, hd, _, with_state = case
    _check(_inputs(b, t, h, hd, with_state, seed=sum(case)), dtype)


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("with_state", [False, True])
def test_chunk_parallel_lengths(t, with_state):
    """Chunk and sub-chunk edges, and 64 chunks carried, in f32."""
    _check(_inputs(1, t, 2, 32, with_state, seed=t + with_state), "float32")


@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("with_state", [False, True])
def test_chunk_parallel_strong_decay(t, with_state):
    """Decay down to ~1e-24: every factor is 2^(a sum of log-decays) <= 1,
    so nothing overflows, and the sums are exact enough that 1e-5 holds."""
    _check(_inputs(1, t, 2, 16, with_state, seed=7 + t, strong=True), "float32")


@pytest.mark.parametrize("strong", [False, True])
def test_every_exponent_is_at_most_zero(strong):
    """Each exponent the factorisation forms is a sum of log-decays, so <= 0
    (an exponent above 0 could overflow under strong decay), and finite."""
    b, t, h, hd = 2, 77, 3, 16                          # three chunks, the last ragged
    w = torch.from_numpy(_inputs(b, t, h, hd, False, seed=11, strong=strong)[3])
    ex = ref.rwkv6_chunk_exponents(w)
    nc = 3
    shapes = {
        "diag": (b, h, nc, 2, 120, hd), "r_edge": (b, h, nc, 16, hd),
        "k_edge": (b, h, nc, 16, hd), "carry_in": (b, h, nc, 32, hd),
        "carry_out": (b, h, nc, 32, hd), "chunk_decay": (b, h, nc, hd),
    }
    assert {name: tuple(x.shape) for name, x in ex.items()} == shapes
    for name, x in ex.items():
        assert bool(torch.isfinite(x).all()), name
        assert float(x.max()) <= 0.0, (name, float(x.max()))
        assert bool(torch.isfinite(torch.exp2(x)).all()), name


# clusters of R = 1 .. 16 CTAs the card holds at once for the T > 1
# kernel at hd 64, by dtype (both instantiations alike), as chip_smoke.py
# phase 1 printed them on an NVIDIA H100 80GB HBM3 (three bf16 CTAs an SM,
# two f32; a cluster within one GPC)
H100_AT_ONCE = {
    torch.bfloat16: (396, 198, 124, 92, 69, 62, 47, 45, 37, 30, 28, 28, 23, 21, 21, 21),
    torch.float32: (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14),
}


def _h100(dtype):
    return lambda ranks, one_chunk: H100_AT_ONCE[dtype][ranks - 1]


# (b, t, h) -> {dtype: (ranks, chunks a rank, waves)} on the H100: the
# served prefill (bf16 9 ranks fit one wave, 8 take the same 2 chunks a
# rank; f32 7 fit, 6 take the same 3), the training forward (2 of 2), T =
# 2048 (16 of 4), two chunks, one chunk, and 512 clusters, which fit one
# wave at no R (bf16: 2, 4 and 8 ranks all take 24 waves x chunks, the
# fewest; f32: 1 and 2 ranks 32)
BF16, F32 = torch.bfloat16, torch.float32
PLANS = {(1, 500, 32): {BF16: (8, {2}, 1), F32: (6, {3, 2}, 1)},
         (4, 128, 32): {BF16: (2, {2}, 1), F32: (2, {2}, 1)},
         (1, 2048, 4): {BF16: (16, {4}, 1), F32: (16, {4}, 1)},
         (2, 33, 4): {BF16: (2, {1}, 1), F32: (2, {1}, 1)},
         (1, 32, 8): {BF16: (1, {1}, 1), F32: (1, {1}, 1)},
         (3, 17, 2): {BF16: (1, {1}, 1), F32: (1, {1}, 1)},
         (16, 500, 32): {BF16: (2, {8}, 3), F32: (1, {16}, 2)}}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_cluster_plan_of_the_main_shapes(shape):
    """The kernel's grid on the H100's counts of clusters at once: one
    cluster per (b, h) of the ranks that fit one wave with the fewest chunks
    a rank, and the fewest such ranks; where none fits one wave, the fewest
    waves x chunks a rank."""
    b, t, h = shape
    for dtype, (ranks, per, waves) in PLANS[shape].items():
        plan = rk.cluster_plan(b, t, h, 64, dtype, _h100(dtype))
        assert (plan.ranks, plan.chunks, plan.grid) == (ranks, -(-t // 32), (ranks, h, b))
        assert {n for _, n in plan.runs} == per
        assert (plan.waves, plan.at_once) == (waves, H100_AT_ONCE[dtype][ranks - 1])


def test_cluster_plan_never_exceeds_r_max():
    """Ranks at most R_MAX (16) and at most the chunks: with room for every
    cluster, min(chunks, 16) where that is the fewest chunks a rank; a card
    that holds no cluster above 8 gets at most 8; one chunk a rank asks for
    the one-chunk instantiation; refused head dims and dtypes raise, and so
    does a card that holds no cluster."""
    roomy = lambda ranks, one_chunk: 10**6
    for t in (1, 31, 33, 100, 257, 500, 1000, 4096):
        nc = -(-t // 32)
        plan = rk.cluster_plan(1, t, 4, 32, torch.float32, roomy)
        assert plan.ranks == min(-(-nc // -(-nc // 16)), nc) and plan.ranks <= 16
        assert plan.runs == tuple(ref.rwkv6_rank_runs(plan.chunks, plan.ranks))
        portable = rk.cluster_plan(1, t, 4, 32, torch.float32, lambda r, one: 10 if r <= 8 else 0)
        assert portable.ranks <= min(nc, 8) and portable.waves == 1
    asked = []
    rk.cluster_plan(1, 100, 4, 64, torch.bfloat16, lambda r, one: asked.append((r, one)) or 1)
    assert asked == [(1, False), (2, False), (3, False), (4, True)]
    with pytest.raises(ValueError):
        rk.cluster_plan(1, 64, 4, 48, torch.float32, roomy)
    with pytest.raises(TypeError):
        rk.cluster_plan(1, 64, 4, 64, torch.float16, roomy)
    with pytest.raises(ValueError):
        rk.cluster_plan(1, 64, 4, 64, torch.float32, lambda r, one: 0)
