"""Cluster flash decode on the CPU: the plain twin of the kernel's schedule
and merge, its tile owners, and the wrapper's cluster plan.

``ref.decode_attention_cluster_reference`` computes what each rank of the
kernel's cluster keeps (its tiles ``t % C == rank`` in order, empty tiles
skipped, an online softmax in log2 units per 64-slot tile) and the merge of
the ranks' states in ``csrc/decode_attention.cu``; it is held to the JAX
oracle ``repro.kernels.ref.decode_attention_reference`` on the same numpy
inputs from a seed.  Tolerance 1e-5 in f32: the same f32 softmax with the
sums taken tile by tile and rank by rank, rounding of ~1e-7 relative on
outputs of size ~1; 2e-2 in bf16, as ``tests/test_kernels.py`` (one bf16
rounding of the output; the twin keeps the probabilities in f32 where the
oracle rounds them to bf16).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import inspect

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
CLUSTERS = [1, 2, 3, 4, 8, 16]


def _ring_window(b, s, rng):
    """A ring of s slots after each sequence wrote positions 0..t (slot =
    pos % s, the latest write wins) under a window of 3s/4 positions: the
    ring has wrapped for most, so the valid slots are a band that wraps
    around the end (``attention.attention_decode``'s mask)."""
    t = rng.integers(s // 2, 3 * s, size=(b, 1))
    slot = np.arange(s)[None, :]
    sp = slot + s * ((t - slot) // s)              # the latest position p <= t in each slot
    return (sp >= 0) & (sp <= t) & (sp > t - (3 * s) // 4)


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
    elif kind == "ring_window":
        valid = _ring_window(b, s, rng)
    else:
        raise ValueError(kind)
    valid[np.arange(b), rng.integers(0, s, size=b)] = True
    return valid


def _inputs(b, s, nq, nkv, hd, kind, seed, dtype="float32", valid=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)))
    if valid is None:
        valid = _mask(kind, b, s, rng)
    jd, td = DTYPES[dtype]
    jax_in = [jnp.asarray(x, jd) for x in (q, k, v)] + [jnp.asarray(valid)]
    torch_in = [torch.from_numpy(x).to(td) for x in (q, k, v)] + [torch.from_numpy(valid)]
    return jax_in, torch_in


def _err(j_out, t_out) -> float:
    return float(np.max(np.abs(np.asarray(j_out.astype(jnp.float32)) - t_out.float().numpy())))


@pytest.mark.parametrize("clusters", CLUSTERS)
@pytest.mark.parametrize("kind", ["random", "prefix", "ring_holes", "ring_window"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cluster_reference_matches_jax(shape, kind, clusters):
    jx, tx = _inputs(*shape, kind, seed=sum(shape) + clusters + len(kind))
    exp = jref.decode_attention_reference(*jx)
    out = ref.decode_attention_cluster_reference(*tx, clusters)
    assert out.shape == tx[0].shape and out.dtype == torch.float32
    assert _err(exp, out) < TOL["float32"]


@pytest.mark.parametrize("clusters", [2, 16])
@pytest.mark.parametrize("kind", ["ring_holes", "ring_window"])
def test_cluster_reference_matches_jax_bf16(kind, clusters):
    jx, tx = _inputs(2, 300, 8, 2, 64, kind, seed=clusters, dtype="bfloat16")
    out = ref.decode_attention_cluster_reference(*tx, clusters)
    assert out.dtype == torch.bfloat16
    assert _err(jref.decode_attention_reference(*jx), out) < TOL["bfloat16"]


@pytest.mark.parametrize("b,nkv,s,sm", [(8, 16, 2048, 132), (8, 1, 2048, 132),
                                         (1, 2, 1000, 132), (2, 4, 333, 78)])
def test_cluster_reference_on_the_kernels_plan(b, nkv, s, sm):
    """The cluster size the wrapper gives the kernel, with the main path's
    prefix masks, with holes and with a window over a wrapped ring."""
    clusters = da.cluster_plan(b, nkv, s, sm)
    assert clusters > 1
    for kind in ("prefix", "ring_holes", "ring_window"):
        jx, tx = _inputs(b, s, 2 * nkv, nkv, 16, kind, seed=s + clusters)
        out = ref.decode_attention_cluster_reference(*tx, clusters)
        assert _err(jref.decode_attention_reference(*jx), out) < TOL["float32"]


@pytest.mark.parametrize("clusters", CLUSTERS)
def test_cluster_reference_all_empty_gives_zero(clusters):
    """No sequence has a valid slot: every output is 0, as the kernels give
    (the oracle spreads its softmax over the masked slots instead); and with
    one sequence empty among others, the others are unaffected."""
    _, tx = _inputs(3, 200, 4, 2, 32, "random", seed=clusters,
                    valid=np.zeros((3, 200), dtype=bool))
    assert not bool(ref.decode_attention_cluster_reference(*tx, clusters).any())
    jx, tx = _inputs(3, 200, 4, 2, 32, "random", seed=clusters)
    tx[3][1] = False
    out = ref.decode_attention_cluster_reference(*tx, clusters)
    assert not bool(out[1].any())
    exp = jref.decode_attention_reference(*jx[:3], jnp.asarray(tx[3].numpy()))
    assert _err(exp[np.array([0, 2])], out[[0, 2]]) < TOL["float32"]


@pytest.mark.parametrize("clusters", CLUSTERS)
def test_cluster_reference_single_slot_in_the_last_tile_of_the_last_rank(clusters):
    """2C tiles, the last (rank C - 1's) ragged, valid only at its last
    slot: the output is that slot's v for every head of the group."""
    s = 2 * 64 * clusters - 5
    assert ref.decode_tile_owners(s, clusters)[-1][-1] == 2 * clusters - 1
    q, k, v = (torch.from_numpy(np.random.default_rng(clusters).standard_normal(sh)
                                .astype(np.float32))
               for sh in ((1, 4, 16), (1, s, 2, 16), (1, s, 2, 16)))
    valid = torch.zeros((1, s), dtype=torch.bool)
    valid[0, s - 1] = True
    out = ref.decode_attention_cluster_reference(q, k, v, valid, clusters)
    assert float((out[0] - v[0, s - 1].repeat_interleave(2, dim=0)).abs().max()) < 1e-6


@pytest.mark.parametrize("s,clusters", [(1, 1), (64, 1), (65, 2), (2048, 3), (448, 16),
                                        (2048, 16)])
def test_tile_owners_deal_every_tile_once_round_robin(s, clusters):
    owners = ref.decode_tile_owners(s, clusters)
    n_tiles = -(-s // 64)
    assert len(owners) == clusters
    assert sorted(t for tiles in owners for t in tiles) == list(range(n_tiles))
    for rank, tiles in enumerate(owners):
        assert tiles == sorted(tiles) and all(t % clusters == rank for t in tiles)
        assert len(tiles) in (n_tiles // clusters, -(-n_tiles // clusters))
    # ranks past the last tile get none (448 slots are 7 tiles)
    assert sum(not tiles for tiles in owners) == max(0, clusters - n_tiles)


def test_cluster_reference_refuses_a_bad_cluster():
    q, k = torch.zeros((1, 2, 16)), torch.zeros((1, 10, 2, 16))
    valid = torch.ones((1, 10), dtype=torch.bool)
    with pytest.raises(ValueError, match="ranks"):
        ref.decode_attention_cluster_reference(q, k, k, valid, 0)


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
def test_cluster_plan_covers_every_tile_once(b, nkv, s, sm):
    clusters = da.cluster_plan(b, nkv, s, sm)
    assert 1 <= clusters <= da.MAX_CLUSTER
    owners = ref.decode_tile_owners(s, clusters)
    assert sorted(t for tiles in owners for t in tiles) == list(range(-(-s // da.TILE)))
    assert all(owners)                       # the plan gives no rank an empty share by shape
    if clusters > 1:
        # no more CTAs than the aim needs, unless the cluster is capped
        assert b * nkv * (clusters - 1) < da.CTAS_PER_SM * sm
    if b * nkv >= da.CTAS_PER_SM * sm:
        assert clusters == 1


@pytest.mark.parametrize("b,nkv,s,at_once,expected", [
    # one CTA an SM (hd 256): 8 clusters of 16 would need two waves
    (8, 1, 2048, lambda c: {1: 132}.get(c, 7 if c > 8 else 15), 8),
    (8, 1, 2048, lambda c: {1: 132, 16: 8}.get(c, 0), 16),   # they fit in one
    (2, 1, 64, lambda c: {1: 100}.get(c, 0), 1),              # never below one CTA
    # three CTAs an SM: the shape rule stands, a short second wave included
    (8, 16, 2048, lambda c: {1: 396, 3: 124}.get(c, 198), 3),
    (8, 8, 2048, lambda c: {1: 396}.get(c, 47), 5),
])
def test_cluster_plan_keeps_one_wave_where_a_cluster_takes_whole_sms(b, nkv, s, at_once, expected):
    """With the card's count of clusters it holds at once: where it holds
    fewer than two CTAs an SM, C shrinks until the call's b x nkv clusters
    run in one wave; elsewhere the shape rule's C stands."""
    assert da.cluster_plan(b, nkv, s, 132, at_once) == expected
    assert da.cluster_plan(b, nkv, s, 132, lambda c: 10**6) == da.cluster_plan(b, nkv, s, 132)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,hd", [(1, 64), (4, 128), (8, 112), (16, 256), (32, 64), (64, 16),
                                      (48, 32)])
def test_heads_per_cta_divides_the_group(dtype, group, hd):
    """The heads one cluster serves: the whole group of <= 16 in bf16 (the
    tensor cores), else a divisor of the group with heads x hd <= 1024."""
    g = da.heads_per_cta(dtype, group, hd)
    assert group % g == 0
    if dtype == torch.bfloat16 and group <= 16:
        assert g == group
    else:
        assert g * hd <= da.SIMT_OUTPUTS and not any(
            group % h == 0 and h * hd <= da.SIMT_OUTPUTS for h in range(g + 1, group + 1))


def test_cluster_plan_takes_shapes_only():
    """The plan is a function of four ints and, optionally, of the card's
    cluster occupancy: no mask, no tensor, so no host sync on the decode
    path."""
    assert list(inspect.signature(da.cluster_plan).parameters) == [
        "b", "nkv", "s", "sm_count", "clusters_at_once"]
    assert da.cluster_plan(8, 16, 2048, 132) == da.cluster_plan(8, 16, 2048, 132)


@pytest.mark.parametrize("b,nkv,s,expected", [
    (8, 16, 2048, 3),     # qwen1.5-0.5b, the main path: 128 pairs -> 384 CTAs
    (8, 8, 2048, 5),      # phi3.5-moe, 32:8 (and kimi-k2, 64:8): 64 pairs -> 320
    (8, 1, 2048, 16),     # recurrentgemma-9b, 16:1: 8 pairs, capped at 16 (non-portable)
    (8, 12, 448, 3),      # whisper-small, cache 448: 96 pairs -> 288
    (8, 8, 4096, 5),      # llama3-8b
    (33, 8, 4096, 1),     # 264 CTAs: 2 per SM already
    (1, 1, 100, 2),       # as many ranks as tiles
])
def test_cluster_plan_on_the_h100(b, nkv, s, expected):
    assert da.cluster_plan(b, nkv, s, 132) == expected
