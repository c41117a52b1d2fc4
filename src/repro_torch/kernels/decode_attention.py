"""Flash-decode on the card: wrapper of ``csrc/decode_attention.cu``.

The CUDA kernel replaces the TPU kernel ``repro/kernels/decode_attention.py``
(see the note at the top of the source).  This wrapper checks its operands,
allocates the output, picks the cluster size (``cluster_plan``), launches
one kernel on the current stream and counts launches: one per call.  Any
GQA group size is taken: the kernel cuts a group whose outputs its SIMT
warpgroup cannot hold (more than 1024 heads x hd) into chunks of heads, one
cluster each.  It takes CUDA tensors only; ``ops.decode_attention`` sends
CPU tensors to the plain version in ``ref.py``
(``ref.decode_attention_cluster_reference`` is the plain version of the
kernel's tile schedule and merge).  Decoding takes no gradient: the wrapper
refuses an input that requires one under grad mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
TILE = 64                # cache slots of a tile; tile t belongs to cluster rank t % C
CTAS_PER_SM = 2          # what the cluster size aims at
MAX_CLUSTER = 16         # the largest cluster Hopper launches (above 8: non-portable)
SIMT_OUTPUTS = 1024      # heads x hd one CTA of the SIMT path holds

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0

# (q, k, v, valid, out) pointers, dtype code, shape and cluster ints,
# scale, device, stream
_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_CLUSTER_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]

_sm_counts = {}
_at_once = {}


def cluster_plan(b: int, nkv: int, s: int, sm_count: int, clusters_at_once=None) -> int:
    """``C``, the CTAs of the cluster that serves one (sequence, kv head):
    tile ``t`` (slots ``[64 t, 64 t + 64)``) belongs to rank ``t % C``
    (``ref.decode_tile_owners``).  C aims at ``CTAS_PER_SM`` CTAs per SM, is
    1 once ``b * nkv`` alone reaches that, and is at most ``MAX_CLUSTER``
    and the number of tiles.

    ``clusters_at_once(C)``, where given, is how many clusters of C CTAs the
    card holds at once for the call's kernel (``max_active_clusters``, per
    chunk of heads).  Where it holds fewer than two a SM of the call's
    one-CTA clusters (``clusters_at_once(1) < 2 * sm_count``: one CTA an SM
    at hd 256 and in f32 from hd 112), a cluster needs C whole SMs of one
    GPC, so a second wave waits for a GPC to drain; C then shrinks until
    the ``b * nkv`` clusters run in one wave.  It depends on
    shapes and the card only, never on ``valid``, so choosing it costs no
    host sync."""
    want = -(-CTAS_PER_SM * sm_count // (b * nkv))
    c = max(1, min(want, MAX_CLUSTER, -(-s // TILE)))
    if clusters_at_once is not None and clusters_at_once(1) < CTAS_PER_SM * sm_count:
        while c > 1 and clusters_at_once(c) < b * nkv:
            c -= 1
    return c


def heads_per_cta(dtype: torch.dtype, group: int, hd: int) -> int:
    """The q heads one cluster serves (the kernel's ``heads_per_cta``): a
    bf16 group of <= 16 whole on the tensor cores, else the largest divisor
    of the group whose outputs the SIMT warpgroup holds (heads x hd <= 1024)."""
    if dtype == torch.bfloat16 and group <= 16:
        return group
    g = group
    while g * hd > SIMT_OUTPUTS or group % g:
        g -= 1
    return g


def _sm_count(device: torch.device) -> int:
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device.index]


def clusters_for(b: int, s: int, nq: int, nkv: int, hd: int, dtype: torch.dtype,
                 device: torch.device) -> int:
    """The cluster size a call of these shapes launches on ``device``:
    ``cluster_plan`` with this card's cluster occupancy."""
    group = nq // nkv
    chunks = group // heads_per_cta(dtype, group, hd)
    return cluster_plan(b, nkv, s, _sm_count(device),
                        lambda c: max_active_clusters(dtype, hd, group, c, device) // chunks)


def decode_attention(
    q: torch.Tensor,                 # (B, nq, hd) — one token per sequence
    k_cache: torch.Tensor,           # (B, S, nkv, hd)
    v_cache: torch.Tensor,           # (B, S, nkv, hd)
    valid: torch.Tensor,             # (B, S) bool
) -> torch.Tensor:
    """Attention of each sequence's token over its valid slots, (B, nq, hd)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}"
        )
    b, nq, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != hd or nq % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}")
    if tuple(valid.shape) != (b, s) or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be a ({b}, {s}) bool tensor, got {valid.dtype} {tuple(valid.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported, only {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported")
    if b == 0 or s == 0:
        raise ValueError(f"empty input: {b=} {s=}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_operand(name, t, q.device, q.dtype)
    if valid.device != q.device or not valid.is_contiguous():
        raise ValueError("valid must be contiguous and on q's device")
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    out = torch.empty_like(q)
    clusters = clusters_for(b, s, nq, nkv, hd, q.dtype, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.function("decode_attention", "da_forward", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, s, nq, nkv, hd, clusters,
        hd ** -0.5, q.device.index, stream,
    )
    _build.raise_on_error("decode_attention", err)
    launches += 1
    return out


def max_active_clusters(dtype: torch.dtype, hd: int, group: int, clusters: int,
                        device: torch.device) -> int:
    """How many clusters of ``clusters`` CTAs the card holds at once for the
    kernel a call of (dtype, hd, GQA group) launches
    (``cudaOccupancyMaxActiveClusters`` at its shared memory); 0 means a
    call with that cluster size raises.  Asked of the card once per
    argument set, then remembered."""
    key = (dtype, hd, group, clusters, device.index or 0)
    if key not in _at_once:
        n = ctypes.c_int(0)
        err = _build.function("decode_attention", "da_max_active_clusters", _CLUSTER_ARGTYPES)(
            _build.DTYPE_CODES[dtype], hd, group, clusters, key[-1], ctypes.byref(n))
        _build.raise_on_error("decode_attention", err)
        _at_once[key] = n.value
    return _at_once[key]
