"""Plain PyTorch versions of the kernels (attention and the RWKV-6 scan),
the RG-LRU's sequential oracle, the one-bf16-step bound (with its
large-output inputs) that the bf16 flash kernel is held to, a float64
attention that the f32 one is held to at those inputs, and plain
models of the kernels' own schedules and arithmetic (the flash kernel's
tile walk and its f32 kernel's three tf32 products, the decode kernel's
cluster of ranks, the chunked scan and its cluster kernel's schedule and
tf32 products), which only the tests call.

These are (1) the path ``ops`` takes for tensors on the CPU, and (2) the
oracles every CUDA kernel is held against on the card (``chip_smoke.py``).
They keep the arithmetic of the JAX oracles (``repro/kernels/ref.py``):
logits and softmax in f32 from the inputs' own values, probabilities cast
to v's dtype before the PV product, which accumulates in f32, and the
output cast to q's dtype.  Upcasting a bf16 operand to f32 is exact, so an
f32 product of upcast operands is JAX's ``preferred_element_type=f32``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _softmax_pv(logits: torch.Tensor, v_dtype: torch.dtype) -> torch.Tensor:
    """softmax in f32, then probs rounded to v's dtype and returned as f32."""
    probs = torch.softmax(logits, dim=-1)
    return probs.to(v_dtype).float()


def attention_mask(sq: int, sk: int, *, causal: bool, window: int = 0, q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query row sees (row i at position
    q_offset + i): causal kpos <= qpos, window kpos > qpos - window."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def mha_reference(
    q: torch.Tensor,                 # (B, Sq, nq, hd)
    k: torch.Tensor,                 # (B, Sk, nkv, hd)
    v: torch.Tensor,                 # (B, Sk, nkv, hd)
    *,
    causal: bool = True,
    window: int = 0,                 # 0 = unlimited; else sliding window
    q_offset: int = 0,               # absolute position of q[0] relative to k[0]
) -> torch.Tensor:
    """Quadratic attention with f32 softmax. Returns (B, Sq, nq, hd)."""
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if nq % nkv:
        raise ValueError(f"num q heads {nq} is not a multiple of kv heads {nkv}")
    qg = q.reshape(b, sq, nkv, nq // nkv, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * hd ** -0.5
    mask = attention_mask(sq, sk, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = _softmax_pv(logits, v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, sq, nq, hd).to(q.dtype)


#: classes of a KV tile for a row block in ``flash_tile_plan``
TILE_SKIPPED, TILE_INTERIOR, TILE_MASKED = 0, 1, 2


def flash_bf16_tiles(hd: int) -> Tuple[int, int]:
    """(BM, BN) of ``csrc/flash_attention.cu``'s bf16 kernel at head dim hd:
    two consumers of 64 rows and 64-key tiles below hd 256; one consumer
    (BM 64) at hd 256, where 128-row blocks would fill only half the SMs at
    recurrentgemma-9b's served prefill."""
    return (64, 64) if hd == 256 else (128, 64)


def flash_tile_plan(sq: int, sk: int, *, causal: bool, window: int = 0, q_offset: int = 0,
                    bm: int = 128, bn: int = 64) -> np.ndarray:
    """The tile walk of ``csrc/flash_attention.cu``'s bf16 kernel: for each
    row block of ``bm`` query rows (the last one ragged) and each KV tile of
    ``bn`` keys, whether the block skips the tile (``TILE_SKIPPED``: it
    lies outside [window edge, causal horizon)), runs it unmasked
    (``TILE_INTERIOR``) or evaluates the mask on it (``TILE_MASKED``: it
    crosses Sk, the causal diagonal or the window's edge for some row of
    the block).  The walk starts at the window edge rounded down to a tile
    boundary.  Returns (ceil(sq / bm), ceil(sk / bn)) int8."""
    n_blocks, n_tiles = -(-sq // bm), -(-sk // bn)
    plan = np.full((n_blocks, n_tiles), TILE_SKIPPED, dtype=np.int8)
    for r in range(n_blocks):
        qpos_first = q_offset + r * bm
        qpos_last = q_offset + min((r + 1) * bm, sq) - 1
        k_hi = min(sk, qpos_last + 1) if causal else sk
        k_lo = max(0, qpos_first - window + 1) // bn * bn if window > 0 else 0
        for n0 in range(k_lo, k_hi, bn):
            masked = (n0 + bn > sk or (causal and n0 + bn - 1 > qpos_first)
                      or (window > 0 and n0 <= qpos_last - window))
            plan[r, n0 // bn] = TILE_MASKED if masked else TILE_INTERIOR
    return plan


def flash_tiled_reference(
    q: torch.Tensor,                 # (B, Sq, nq, hd)
    k: torch.Tensor,                 # (B, Sk, nkv, hd)
    v: torch.Tensor,                 # (B, Sk, nkv, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    product: Optional[Callable[..., torch.Tensor]] = None,
) -> torch.Tensor:
    """Attention by the schedule of ``csrc/flash_attention.cu``'s
    tensor-core kernels, in plain PyTorch: row blocks of ``bm``, KV tiles of
    ``bn`` (by default the bf16 kernel's, ``flash_bf16_tiles``), walked as
    ``flash_tile_plan`` says (masks on the masked tiles
    only), the online softmax in log2 units (running max m, alpha =
    2^(m_old - m), the scale folded into the exponent), P V from P's bf16
    high part plus its bf16 low part where v is bf16, and O / l, 0 where a
    row sees no key.  ``product(a, b, c=None)`` (c + a @ b) takes the place
    of every f32 matrix product (Q K^T, and P V into the running O;
    ``flash_tf32_reference`` passes the f32 kernel's three tf32 products).
    Nothing on the card's path calls it; the tests hold it to the JAX
    kernel and oracle.  Returns (B, Sq, nq, hd) in q's dtype."""
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if nq % nkv:
        raise ValueError(f"num q heads {nq} is not a multiple of kv heads {nkv}")
    scale_log2 = hd ** -0.5 * 1.4426950408889634
    bm, bn = bm or flash_bf16_tiles(hd)[0], bn or flash_bf16_tiles(hd)[1]
    plan = flash_tile_plan(sq, sk, causal=causal, window=window, q_offset=q_offset, bm=bm, bn=bn)
    kh = k.float().repeat_interleave(nq // nkv, dim=2).transpose(1, 2)   # (B, nq, Sk, hd)
    vh = v.float().repeat_interleave(nq // nkv, dim=2).transpose(1, 2)
    qh = q.float().transpose(1, 2)                                       # (B, nq, Sq, hd)
    split = v.dtype == torch.bfloat16 and product is None
    mm = product or (lambda a, b, c=None: a @ b if c is None else c + a @ b)
    out = torch.zeros((b, nq, sq, hd), dtype=torch.float32, device=q.device)
    for r in range(plan.shape[0]):
        rows = slice(r * bm, min((r + 1) * bm, sq))
        qpos = q_offset + torch.arange(rows.start, rows.stop, device=q.device)[:, None]
        m = torch.full((b, nq, rows.stop - rows.start), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, nq, rows.stop - rows.start, hd), device=q.device)
        for t in np.flatnonzero(plan[r]):
            keys = slice(t * bn, min((t + 1) * bn, sk))
            s = mm(qh[:, :, rows], kh[:, :, keys].transpose(-1, -2))
            if plan[r, t] == TILE_MASKED:
                kpos = torch.arange(t * bn, (t + 1) * bn, device=q.device)[None, : s.shape[-1]]
                ok = kpos < sk
                if causal:
                    ok = ok & (kpos <= qpos)
                if window > 0:
                    ok = ok & (kpos > qpos - window)
                s = torch.where(ok, s, torch.full_like(s, -float("inf")))
            m_new = torch.maximum(m, s.amax(dim=-1) * scale_log2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None]
            if split:
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                acc = acc + hi @ vh[:, :, keys] + lo @ vh[:, :, keys]
            else:
                acc = mm(p, vh[:, :, keys], acc)
            m = m_new
        safe = torch.where(l > 0, l, torch.ones_like(l))
        out[:, :, rows] = torch.where(l[..., None] > 0, acc / safe[..., None],
                                      torch.zeros_like(acc))
    return out.transpose(1, 2).to(q.dtype)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as a tf32 (sign, 8 exponent and 10 mantissa bits), its low
    13 bits cleared: what the tensor cores read from an f32 operand, and
    what ``csrc/flash_attention.cu``'s f32 kernel masks P and V^T to."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to the nearest tf32 (ties away from zero; low 13
    bits cleared), as ``csrc/rwkv6_scan.cu`` forms an operand's big part:
    the tensor cores then read it whole, and x - big is at most half a tf32
    step with either sign."""
    return ((x.float().contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` as the f32 next to it on the side of 0."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tf32_product(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None, *,
                 products: int = 3, accumulate: str = "truncate",
                 big: str = "truncate") -> torch.Tensor:
    """c + a @ b (c = 0 when None) as the f32 flash kernel computes it on
    the tensor cores: each operand x split into big = tf32(x) and small =
    tf32(x - big) (x - big is exact in f32), and big.small + small.big +
    big.big (``products=3``) or big.big alone (``products=1``, one tf32
    product).  ``big="round"`` takes big = tf32_round(x) instead, as the
    scan kernel does.  A product of two tf32 values is exact in f32.
    ``accumulate="truncate"`` models the tensor cores: the kernel's wgmma
    in its order (product by product, the small ones first, 8 of the
    contraction a wgmma), each adding its exact sum to the accumulators
    rounded toward zero; ``"exact"`` sums in f32, ~20 times faster here."""
    if big not in ("truncate", "round"):
        raise ValueError(f"big {big!r} is neither 'truncate' nor 'round'")
    split = tf32 if big == "truncate" else tf32_round
    a_big, b_big = split(a), split(b)
    if products == 3:
        terms = [(a_big, tf32(b - b_big)), (tf32(a - a_big), b_big), (a_big, b_big)]
    elif products == 1:
        terms = [(a_big, b_big)]
    else:
        raise ValueError(f"products must be 1 or 3, got {products}")
    if accumulate == "exact":
        out = sum(x @ y for x, y in terms)
        return out if c is None else c + out
    if accumulate != "truncate":
        raise ValueError(f"accumulate {accumulate!r} is neither 'exact' nor 'truncate'")
    d = c
    for x, y in terms:
        for k0 in range(0, a.shape[-1], 8):
            step = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            d = _round_toward_zero(step if d is None else d.double() + step)
    return d


def flash_tf32_tiles(hd: int) -> Tuple[int, int]:
    """(BM, BN) of ``csrc/flash_attention.cu``'s f32 kernel at head dim hd:
    two consumers of 64 rows and 64-key tiles up to hd 64; one consumer and
    32-key tiles at hd 112 and 128, where shared memory holds no more, and
    at hd 256, whose two CTAs of a cluster each take 128 of the dims
    (``flash_tf32_cluster``)."""
    return (128, 64) if hd <= 64 else (64, 32)


def flash_tf32_cluster(hd: int) -> int:
    """CTAs of a cluster that split the head dims in ``csrc/flash_attention.cu``'s
    f32 kernel: two of 128 each at hd 256, one below."""
    return 2 if hd == 256 else 1


def flash_tf32_reference(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                         products: int = 3, accumulate: str = "truncate") -> torch.Tensor:
    """The arithmetic of ``csrc/flash_attention.cu``'s f32 kernel on the
    CPU: ``flash_tiled_reference``'s tile walk at the kernel's tiles
    (``flash_tf32_tiles``) with Q K^T and P V each as ``tf32_product`` (by
    default the tensor cores' truncating sums; P V into the running O).  At
    hd 256 (``flash_tf32_cluster``) each CTA of a cluster computes the
    partial S over its 128 dims, and S is the two partials added in f32;
    each does P V over its own dims, which is P V over all of them column by
    column.  Nothing on the card's path calls it; the tests hold it to the
    JAX kernel and oracle, and hold one tf32 product to miss."""
    hd = q.shape[-1]
    bm, bn = flash_tf32_tiles(hd)
    parts = flash_tf32_cluster(hd)

    def product(a, b, c=None):
        if c is not None:      # P V: each output column alike, however the dims are split
            return tf32_product(a, b, c, products=products, accumulate=accumulate)
        w = hd // parts        # S: each CTA's partial over its dims, summed in f32
        partials = [tf32_product(a[..., r * w:(r + 1) * w], b[..., r * w:(r + 1) * w, :],
                                 products=products, accumulate=accumulate)
                    for r in range(parts)]
        return sum(partials[1:], partials[0])

    return flash_tiled_reference(q.float(), k.float(), v.float(), causal=causal, window=window,
                                 q_offset=q_offset, bm=bm, bn=bn, product=product)


def bf16_step(o32: torch.Tensor, floor: float = 2e-2) -> torch.Tensor:
    """One bf16 step of each exact output, ``2^(floor(log2|o32|) - 7)``, and
    never below ``floor``: what a kernel that computes in f32 and rounds its
    output once to bf16 stays within."""
    return torch.clamp(torch.exp2(torch.floor(torch.log2(o32.abs())) - 7), min=floor)


def bf16_steps_from_f32(o, q, k, v, *, causal: bool = False,
                        valid=None) -> torch.Tensor:
    """|o - o32| in bf16 steps of o32 (``bf16_step``), where o32 is the f32
    attention of the same (bf16) inputs; a kernel that rounds once is <= 1.
    With ``valid`` the inputs are a decode step's (q (B, nq, hd) against a
    masked cache) and o32 is ``decode_attention_reference`` in f32."""
    if valid is not None:
        o32 = decode_attention_reference(q.float(), k.float(), v.float(), valid)
    else:
        o32 = mha_reference(q.float(), k.float(), v.float(), causal=causal)
    return (o.float() - o32).abs() / bf16_step(o32)


def attention_f64(q, k, v, *, causal: bool) -> torch.Tensor:
    """Attention of q, k, v (as ``mha_reference`` takes them, from position
    0) in float64 throughout: the bar for an f32 kernel where outputs are
    large enough that the plain f32 version is itself far from exact."""
    q, k, v = q.double(), k.double(), v.double()
    nq, nkv, hd = q.shape[2], k.shape[2], q.shape[3]
    k, v = (x.repeat_interleave(nq // nkv, dim=2) for x in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal, device=q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def large_output_inputs(hd: int, device, dtype=torch.bfloat16):
    """q, k, v whose attention reaches |o| ~ 27 from a few keys (sharp logits,
    large values): seed = hd, S = 256, q, k ~ 3 N, v ~ 6 N, 16 q heads over 4
    kv heads at hd 64 and over 1 at hd 256; made in f32 with numpy."""
    rng = np.random.default_rng(hd)
    s, nq, nkv = 256, 16, 1 if hd == 256 else 4
    return tuple(torch.from_numpy((c * rng.standard_normal((1, s, n, hd))).astype(np.float32))
                 .to(device, dtype) for c, n in ((3.0, nq), (3.0, nkv), (6.0, nkv)))


def large_output_decode_inputs(hd: int, device, dtype=torch.bfloat16, seed=None):
    """q, k, v, valid of a decode step whose outputs reach |o| ~ 20 from a
    few slots (sharp logits, large values): seed = 1000 + hd unless given,
    B = 4, a 512-slot cache holding 512, 384, 200 and 37 tokens, q, k ~ 3 N,
    v ~ 6 N, 16 q heads over 4 kv heads at hd 64 and over 1 at hd 256; made
    in f32 with numpy."""
    rng = np.random.default_rng(1000 + hd if seed is None else seed)
    b, s, nq, nkv = 4, 512, 16, 1 if hd == 256 else 4
    q = 3.0 * rng.standard_normal((b, nq, hd))
    k, v = (c * rng.standard_normal((b, s, nkv, hd)) for c in (3.0, 6.0))
    lengths = np.array([512, 384, 200, 37])
    valid = np.arange(s)[None, :] < lengths[:, None]
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device, dtype)
                 for x in (q, k, v)) + (torch.from_numpy(valid).to(device),)


#: the seeds a decode kernel's rounding is swept over: the default input set
#: of each hd (1000 + hd) and 64 more
DECODE_ROUNDING_SEEDS = tuple(range(2000, 2064))


def decode_rounding_sweep(decode_fn, hd: int, device, seeds=DECODE_ROUNDING_SEEDS) -> dict:
    """``decode_fn(q, k, v, valid)`` on ``large_output_decode_inputs`` of
    hd at its default seed and at each of ``seeds``, in bf16 steps of the
    f32 attention (``bf16_steps_from_f32``): the largest error, its seed,
    |o32| and |o - o32| there, and how many outputs lie over one step."""
    out = {"max_err_in_steps": -1.0, "outputs": 0, "outputs_over_one_step": 0}
    for seed in (1000 + hd,) + tuple(seeds):
        q, k, v, valid = large_output_decode_inputs(hd, device, seed=seed)
        o = decode_fn(q, k, v, valid).float()
        o32 = decode_attention_reference(q.float(), k.float(), v.float(), valid)
        steps = (o - o32).abs() / bf16_step(o32)
        out["outputs"] += steps.numel()
        out["outputs_over_one_step"] += int((steps > 1).sum())
        i = int(steps.argmax())
        if float(steps.flatten()[i]) > out["max_err_in_steps"]:
            out.update(max_err_in_steps=float(steps.flatten()[i]), seed=seed,
                       o32_at_worst=float(o32.flatten()[i]),
                       abs_err_at_worst=float((o - o32).abs().flatten()[i]))
    return out


def decode_attention_reference(
    q: torch.Tensor,                 # (B, nq, hd) — a single new token per seq
    k_cache: torch.Tensor,           # (B, S, nkv, hd)
    v_cache: torch.Tensor,           # (B, S, nkv, hd)
    valid: torch.Tensor,             # (B, S) bool — which cache slots attend
) -> torch.Tensor:
    """Single-token decode oracle. Returns (B, nq, hd)."""
    b, nq, hd = q.shape
    nkv = k_cache.shape[2]
    if nq % nkv:
        raise ValueError(f"num q heads {nq} is not a multiple of kv heads {nkv}")
    qg = q.reshape(b, nkv, nq // nkv, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * hd ** -0.5
    logits = torch.where(
        valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF)
    )
    probs = _softmax_pv(logits, v_cache.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache.float())
    return out.reshape(b, nq, hd).to(q.dtype)


def decode_tile_owners(s: int, clusters: int, tile: int = 64) -> List[List[int]]:
    """The tiles each cluster rank of the decode kernel reads: tile ``t``
    (slots ``[tile t, tile (t + 1))``, the last one up to ``s``) belongs to
    rank ``t % clusters``; a rank past the last tile gets none."""
    if clusters < 1 or s < 1:
        raise ValueError(f"{clusters} ranks cannot cut {s} slots")
    n = -(-s // tile)
    return [list(range(r, n, clusters)) for r in range(clusters)]


def decode_attention_cluster_reference(
    q: torch.Tensor,                 # (B, nq, hd)
    k_cache: torch.Tensor,           # (B, S, nkv, hd)
    v_cache: torch.Tensor,           # (B, S, nkv, hd)
    valid: torch.Tensor,             # (B, S) bool
    clusters: int,
    tile: int = 64,
) -> torch.Tensor:
    """The decode kernel's schedule and merge (``csrc/decode_attention.cu``)
    in f32.

    Rank r of the cluster walks its tiles (``decode_tile_owners``) in order
    and skips a tile with no valid slot.  Per tile, in log2 units (logits
    times ``hd^-0.5 log2 e``): the running max m becomes max(m, the tile's
    max), the old state is scaled by alpha = 2^(m_old - m), and each valid
    slot adds p = 2^(s - m) to the sum l and p v to the accumulator; masked
    slots of the tile add exactly 0.  A rank that saw no valid slot keeps
    m = -1e30, l = 0.  The merge weighs rank c by 2^(m_c - max m) and
    divides the weighted accumulators by the weighted sum; a sequence with
    no valid slot gives 0, as the kernels do.  Nothing on the main path
    calls it; the tests hold it to the JAX oracle.  Returns (B, nq, hd) in
    q's dtype."""
    b, nq, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, nkv, nq // nkv, hd).float()
    scale_log2 = hd ** -0.5 * 1.4426950408889634
    ms, ls, accs = [], [], []
    for tiles in decode_tile_owners(s, clusters, tile):
        m = torch.full((b, nkv, nq // nkv), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (hd,))
        for t in tiles:
            lo, hi = t * tile, min(s, (t + 1) * tile)
            ok = valid[:, None, None, lo:hi]
            logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache[:, lo:hi].float()) * scale_log2
            logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(logits - m_new[..., None]), torch.zeros_like(logits))
            seen = ok.any(dim=-1)                                   # the tile is not skipped
            l = torch.where(seen, l * alpha + p.sum(dim=-1), l)
            acc = torch.where(seen[..., None], acc * alpha[..., None]
                              + torch.einsum("bkgs,bskh->bkgh", p, v_cache[:, lo:hi].float()), acc)
            m = torch.where(seen, m_new, m)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp2(m - m.amax(dim=0))
    total = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0)
    out = torch.where(total[..., None] > 0, out / total.clamp_min(1e-30)[..., None],
                      torch.zeros_like(out))
    return out.reshape(b, nq, hd).to(q.dtype)


def local_attention_blocked(
    q: torch.Tensor,                 # (B, S, nq, hd)
    k: torch.Tensor,                 # (B, S, nkv, hd)
    v: torch.Tensor,                 # (B, S, nkv, hd)
    *,
    window: int,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal sliding-window attention computed block-locally.

    Queries in block i attend keys in blocks {i-1, i}, which is exact for
    window <= block size: O(S * 2W) logits instead of the masked O(S^2).
    """
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    if window <= 0:
        raise ValueError(f"blocked attention needs a positive window, got {window}")
    if q_offset != 0:
        raise ValueError("blocked attention assumes q and k aligned at position 0")
    blk = window
    s_p = -(-s // blk) * blk
    if s_p != s:
        pad = (0, 0, 0, 0, 0, s_p - s)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
    nb = s_p // blk

    qb = q.reshape(b, nb, blk, nq, hd)
    kb = k.reshape(b, nb, blk, nkv, hd)
    vb = v.reshape(b, nb, blk, nkv, hd)
    # keys for block i: [block i-1 ; block i]   (first block: zeros, masked)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)                # (B, nb, 2W, nkv, hd)
    v2 = torch.cat([v_prev, vb], dim=2)

    qg = qb.reshape(b, nb, blk, nkv, nq // nkv, hd)
    logits = torch.einsum(
        "bnqkgh,bnskh->bnkgqs", qg.float(), k2.float()
    ) * hd ** -0.5                                     # (B,nb,nkv,g,W,2W)

    ib = torch.arange(nb, device=q.device)[:, None, None]
    qpos = q_offset + ib * blk + torch.arange(blk, device=q.device)[None, :, None]
    kpos = (ib - 1) * blk + torch.arange(2 * blk, device=q.device)[None, None, :]
    mask = (kpos >= 0) & (kpos <= qpos) & (kpos > qpos - window)  # (nb, W, 2W)
    logits = torch.where(
        mask[None, :, None, None], logits, torch.full_like(logits, NEG_INF)
    )
    probs = _softmax_pv(logits, v2.dtype)
    out = torch.einsum("bnkgqs,bnskh->bnqkgh", probs, v2.float())
    out = out.reshape(b, s_p, nq, hd)
    return out[:, :s].to(q.dtype)


# ---------------------------------------------------------------------------
# RWKV-6 ("Finch") linear-attention recurrence.
#
# Per head with state S in R^{hd x hd}:
#   S_t = diag(w_t) S_{t-1} + k_t v_t^T
#   o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t        (bonus term u on current)
# w_t in (0,1) is the data-dependent decay.
# ---------------------------------------------------------------------------
def rwkv6_reference(
    r: torch.Tensor,                 # (B, T, H, hd)
    k: torch.Tensor,                 # (B, T, H, hd)
    v: torch.Tensor,                 # (B, T, H, hd)
    w: torch.Tensor,                 # (B, T, H, hd) decay in (0,1)
    u: torch.Tensor,                 # (H, hd) per-head bonus
    state: Optional[torch.Tensor] = None,   # (B, H, hd, hd); None = zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle, one token at a time in f32.

    Returns (out (B, T, H, hd) in r's dtype, final state (B, H, hd, hd) f32)."""
    b, t, h, d = r.shape
    if state is None:
        state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    s = state.float()
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k32[:, i, :, :, None] * v32[:, i, :, None, :]          # (B,H,hd,hd)
        outs.append(torch.einsum("bhij,bhi->bhj", s + u32 * kv, r32[:, i]))
        s = w32[:, i, :, :, None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma): elementwise gated linear recurrence
#   h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * x_t
# with x_t the gated input and a_t in (0, 1) the decay.
# ---------------------------------------------------------------------------
def rglru_reference(
    x: torch.Tensor,                 # (B, T, D) gated input
    a: torch.Tensor,                 # (B, T, D) decay in (0, 1)
    h0: Optional[torch.Tensor] = None,   # (B, D); None = zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle, one step at a time in f32.

    Returns (h (B, T, D) in x's dtype, final state (B, D) f32)."""
    b, t, d = x.shape
    h = torch.zeros((b, d), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    x32, a32 = x.float(), a.float()
    outs = []
    for i in range(t):
        a_t = a32[:, i]
        h = a_t * h + torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=0.0)) * x32[:, i]
        outs.append(h)
    return torch.stack(outs, dim=1).to(x.dtype), h


# The chunk-parallel form of ``csrc/rwkv6_scan.cu``'s T > 1 kernel: chunks of
# RWKV_CHUNK tokens, each split at its middle into two sub-chunks.
RWKV_CHUNK = 32
RWKV_SUB = RWKV_CHUNK // 2
# the smallest decay, as the TPU kernel clamps it: keeps log2 finite at w = 0
RWKV_W_MIN = 1e-38
# ranks of the kernel's cluster at most (the largest cluster Hopper launches)
RWKV_R_MAX = 16


def _chunked(x: torch.Tensor, nc: int) -> torch.Tensor:
    """(B, T, H, hd) zero-padded to nc chunks -> (B, H, nc, C, hd), dtype kept."""
    b, t, h, d = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nc * RWKV_CHUNK - t))
    return x.reshape(b, nc, RWKV_CHUNK, h, d).permute(0, 3, 1, 2, 4)


def rwkv6_chunk_exponents(w: torch.Tensor) -> dict:
    """Every base-2 exponent the chunk-parallel form exponentiates, by role.

    ``w`` is (B, T, H, hd).  P[t] is the exclusive prefix of log2 w inside a
    chunk (rows past T add 0), e = RWKV_SUB the sub-chunk edge and L the
    chunk's last row + 1:
      diag        P[t] - P[s+1], s < t in the same sub-chunk  (B,H,nc,2,120,hd)
      r_edge      P[t] - P[e] for t >= e                      (B,H,nc,16,hd)
      k_edge      P[e] - P[s+1] for s < e                     (B,H,nc,16,hd)
      carry_in    P[t]                                        (B,H,nc,C,hd)
      carry_out   P[L] - P[s+1]                               (B,H,nc,C,hd)
      chunk_decay P[L]                                        (B,H,nc,hd)
    Each is the sum of the log-decays between its two ends, so <= 0.  The
    kernel sums them directly, walking the tokens, and never subtracts two
    prefixes, which under strong decay are large and would cancel; here they
    are differences of float64 prefixes, the same sums to f32's precision.
    All are returned in f32."""
    nc = -(-w.shape[1] // RWKV_CHUNK)
    lw = _chunked(torch.log2(w.float().clamp_min(RWKV_W_MIN)), nc)
    incl = torch.cumsum(lw.double(), dim=3)                 # P[t + 1]
    excl = torch.nn.functional.pad(incl, (0, 0, 1, 0))[:, :, :, :-1]   # P[t]
    p_l = incl[:, :, :, -1]                                 # P[L]
    e = RWKV_SUB
    ti, si = torch.tril_indices(e, e, -1, device=w.device)  # the 120 pairs s < t
    diag = torch.stack([excl[:, :, :, o + ti] - incl[:, :, :, o + si] for o in (0, e)], dim=3)
    p_e = excl[:, :, :, e:e + 1]                            # P[e]
    ex = {
        "diag": diag,
        "r_edge": excl[:, :, :, e:] - p_e,
        "k_edge": p_e - incl[:, :, :, :e],
        "carry_in": excl,
        "carry_out": p_l[:, :, :, None] - incl,
        "chunk_decay": p_l,
    }
    return {name: x.float() for name, x in ex.items()}


def rwkv6_chunk_parallel_reference(
    r: torch.Tensor,                 # (B, T, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,                 # decay in (0, 1)
    u: torch.Tensor,                 # (H, hd)
    state: Optional[torch.Tensor] = None,   # (B, H, hd, hd) f32; None = zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel arithmetic of the scan, in f32 products: what the
    dry-run counts (``launch/dryrun.py``) and ``ops`` runs on meta tensors.

    Per chunk of C = 32 tokens, in the exponents of ``rwkv6_chunk_exponents``:
      A[t,s]  = sum_i r_ti k_si 2^(P[t,i] - P[s+1,i]), s < t:
                pairwise where s and t share a sub-chunk; for t >= e > s the
                product (r_t 2^(P[t]-P[e])) . (k_s 2^(P[e]-P[s+1]));
      o_t     = sum_s A[t,s] v_s + ((r_t u) . k_t) v_t + (r_t 2^P[t]) S_{c-1};
      dS_c    = sum_s (k_s 2^(P[L]-P[s+1])) v_s^T,   S_c = 2^P[L] S_{c-1} + dS_c,
    the carry S_c the only serial step.  Everything is f32
    (``rwkv6_cluster_reference`` takes the products as the kernel does).
    The tests hold it to the JAX oracle.  Returns (out (B, T, H, hd) in r's
    dtype, final state (B, H, hd, hd) f32)."""
    b, t, h, d = r.shape
    nc = -(-t // RWKV_CHUNK)
    e = RWKV_SUB
    rc, kc, vc = (_chunked(x.float(), nc) for x in (r, k, v))   # (B, H, nc, C, hd)
    ex = rwkv6_chunk_exponents(w)
    # A: the diagonal sub-chunk blocks pairwise, the off-diagonal one as a product
    a = torch.zeros((b, h, nc, RWKV_CHUNK, RWKV_CHUNK), dtype=torch.float32, device=r.device)
    ti, si = torch.tril_indices(e, e, -1, device=r.device)
    for n, o in enumerate((0, e)):
        a[:, :, :, o + ti, o + si] = (rc[:, :, :, o + ti] * kc[:, :, :, o + si]
                                      * torch.exp2(ex["diag"][:, :, :, n])).sum(-1)
    r_hat = rc[:, :, :, e:] * torch.exp2(ex["r_edge"])
    k_hat = kc[:, :, :, :e] * torch.exp2(ex["k_edge"])
    a[:, :, :, e:, :e] = r_hat @ k_hat.transpose(-1, -2)
    bonus = (rc * u.float()[None, :, None, None, :] * kc).sum(-1, keepdim=True)
    o_intra = a @ vc + bonus * vc
    # per-chunk state increments and decays, then the serial carry
    d_state = (kc * torch.exp2(ex["carry_out"])).transpose(-1, -2) @ vc   # (B,H,nc,hd,hd)
    decay = torch.exp2(ex["chunk_decay"])                   # (B, H, nc, hd)
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    carries = []
    for c in range(nc):
        carries.append(s)
        s = decay[:, :, c, :, None] * s + d_state[:, :, c]
    o_inter = (rc * torch.exp2(ex["carry_in"])) @ torch.stack(carries, dim=2)
    out = (o_intra + o_inter).permute(0, 2, 3, 1, 4).reshape(b, nc * RWKV_CHUNK, h, d)
    return out[:, :t].to(r.dtype), s


def rwkv6_rank_runs(nc: int, ranks: int) -> List[Tuple[int, int]]:
    """(first chunk, chunks) of each rank of the scan kernel's cluster: nc
    chunks in contiguous runs, the first ``nc % ranks`` ranks one longer."""
    if not 1 <= ranks <= nc:
        raise ValueError(f"ranks must be in [1, {nc}], got {ranks}")
    per, extra = divmod(nc, ranks)
    return [(q * per + min(q, extra), per + (q < extra)) for q in range(ranks)]


def rwkv6_carry_owners(hd: int, ranks: int) -> torch.Tensor:
    """(hd, hd) int64: the rank of the scan kernel's cluster that carries
    each element (i, j) of the state between its two barriers.  The kernel
    holds S^T in wgmma accumulators, four elements (i, j), (i + 1, j),
    (i, j + 8), (i + 1, j + 8) a 16-byte slot, with i = 8 k + 2 (t % 4) and
    j = 16 (t / 32) + (t % 32) / 4 for slot k of thread t; only the first
    TV = min(threads, 2 hd) threads hold rows below hd (128 threads up to
    hd 64, 256 at hd 128).  Slot v is slot v / TV of thread v % TV, and rank
    q owns slots [q NV / R, (q + 1) NV / R) of the NV = hd / 8 * TV."""
    tv = min(128 if hd <= 64 else 256, 2 * hd)
    nv = hd // 8 * tv
    owner = torch.full((hd, hd), -1, dtype=torch.int64)
    for q in range(ranks):
        for v in range(q * nv // ranks, (q + 1) * nv // ranks):
            k4, t = divmod(v, tv)
            i, j = 8 * k4 + 2 * (t % 4), 16 * (t // 32) + (t % 32) // 4
            owner[i:i + 2, j] = q
            owner[i:i + 2, j + 8] = q
    return owner


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as fmaf."""
    return (a.double() * b.double() + c.double()).float()


def rwkv6_cluster_reference(
    r: torch.Tensor,                 # (B, T, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,                 # decay in (0, 1)
    u: torch.Tensor,                 # (H, hd)
    state: Optional[torch.Tensor] = None,   # (B, H, hd, hd) f32; None = zeros
    *,
    ranks: Optional[int] = None,
    products: int = 3,
    accumulate: str = "truncate",
    final_state: Optional[torch.Tensor] = None,   # (B, H, hd, hd) f32; may be ``state``
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The schedule and arithmetic of ``csrc/rwkv6_scan.cu``'s T > 1 kernel
    on the CPU, f32 and bf16 alike.

    Per chunk, the terms of ``rwkv6_chunk_parallel_reference`` (its
    exponents, and A's pairs in f32: the kernel forms each factor as a
    product of decays and A's pairs on five levels of blocks, the same
    values to f32's precision) with the bonus (r_t u) . k_t on A's
    diagonal; the kernel's three products with its operands swapped, each a
    ``tf32_product`` with big parts rounded to nearest (by default the
    tensor cores' truncating sums, three tf32 products; bf16 r, k, v are
    exact in tf32):
      (1) V^T A^T and (2) S^T (r 2^P)^T, each from zero and added in f32:
      o^T = (1) + (2);
      (3) S_c^T = V^T (k 2^(P[L]-P[s+1])) added to S_{c-1}^T diag(2^P[L]).
    The carry as the cluster takes it: ``ranks`` (default min(chunks,
    RWKV_R_MAX)) runs of chunks (``rwkv6_rank_runs``).  One rank: its run
    from the state, (3) after every chunk, the last the final state.
    Several: pass 1 folds each run into its composite (D_q, dS_q) by (3)
    from zero, D_q the product of its chunks' 2^P[L]; then each element of
    the state is carried by the rank that owns it (``rwkv6_carry_owners``)
    as a serial chain c_0 = the state's element (0 where it is None),
    c_{q+1} = D_q c_q + dS_q (one f32 rounding, fmaf), c_q rank q's
    carry-in and c_R the final state's element; pass 2 walks each run from
    its carry-in, (1) and (2) per chunk, (3) between its chunks.  As in the
    kernel, an owner reads an element of the state just before it writes
    that element of ``final_state``, which may be ``state`` itself; with
    one chunk a rank, rank 0 reads the whole state for its (2) before any
    owner writes.  The output is rounded once to r's dtype.  Nothing on the
    card's path calls it; the tests hold it to the JAX oracle and the
    Pallas kernel.  Returns (out (B, T, H, hd) in r's dtype, final state
    (B, H, hd, hd) f32: ``final_state`` where it is given)."""
    b, t, h, d = r.shape
    nc = -(-t // RWKV_CHUNK)
    ranks = min(nc, RWKV_R_MAX) if ranks is None else ranks
    runs = rwkv6_rank_runs(nc, ranks)
    e = RWKV_SUB
    rc, kc, vc = (_chunked(x.float(), nc) for x in (r, k, v))   # (B, H, nc, C, hd)
    ex = rwkv6_chunk_exponents(w)
    a = torch.zeros((b, h, nc, RWKV_CHUNK, RWKV_CHUNK), dtype=torch.float32, device=r.device)
    ti, si = torch.tril_indices(e, e, -1, device=r.device)
    for n, o in enumerate((0, e)):
        a[:, :, :, o + ti, o + si] = (rc[:, :, :, o + ti] * kc[:, :, :, o + si]
                                      * torch.exp2(ex["diag"][:, :, :, n])).sum(-1)
    r_hat = rc[:, :, :, e:] * torch.exp2(ex["r_edge"])
    k_hat = kc[:, :, :, :e] * torch.exp2(ex["k_edge"])
    a[:, :, :, e:, :e] = r_hat @ k_hat.transpose(-1, -2)
    diag = torch.arange(RWKV_CHUNK, device=r.device)
    a[:, :, :, diag, diag] = (rc * u.float()[None, :, None, None, :] * kc).sum(-1)   # the bonus
    rt_t = (rc * torch.exp2(ex["carry_in"])).transpose(-1, -2)    # (r 2^P)^T: (hd, C)
    kt = kc * torch.exp2(ex["carry_out"])                         # (C, hd)
    dec = torch.exp2(ex["chunk_decay"])                           # (B, H, nc, hd)
    v_t, a_t = vc.transpose(-1, -2), a.transpose(-1, -2)

    def prod(x, y, c=None):
        return tf32_product(x, y, c, products=products, accumulate=accumulate, big="round")

    def step(s_t, c):                  # (3): S^T's columns are the state rows i
        return prod(v_t[:, :, c], kt[:, :, c], s_t * dec[:, :, c, None, :])

    def outputs(s_t, c):               # o^T = (1) + (2), its sums in f32
        return (prod(v_t[:, :, c], a_t[:, :, c]).double()
                + prod(s_t, rt_t[:, :, c]).double()).float().transpose(-1, -2)

    zeros = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    # the state as S^T, read where the kernel reads it whole: one rank, or
    # rank 0 of one chunk a rank
    s0_t = zeros if state is None else state.float().transpose(-1, -2).clone()
    if final_state is None:
        final_state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    out = torch.zeros_like(vc)
    if ranks == 1:
        s_t = s0_t
        for c in range(nc):
            out[:, :, c] = outputs(s_t, c)
            s_t = step(s_t, c)
        final_state.copy_(s_t.transpose(-1, -2))
    else:
        comp, dr = [], []
        for c0, n in runs:                                        # pass 1
            s_t, dq = zeros, torch.ones_like(dec[:, :, 0])
            for c in range(c0, c0 + n):
                s_t = step(s_t, c)
                dq = dq * dec[:, :, c]
            comp.append(s_t)
            dr.append(dq)
        carries = [torch.empty_like(zeros) for _ in range(ranks)]
        fin_t = final_state.transpose(-1, -2)
        for q, mine in enumerate(rwkv6_carry_owners(d, ranks).to(r.device).T == torch.arange(
                ranks, device=r.device)[:, None, None]):          # the carry, S^T's (j, i)
            c_el = zeros[..., mine] if state is None else state.transpose(-1, -2)[..., mine].float()
            for p in range(ranks):
                carries[p][..., mine] = c_el
                c_el = _fma(dr[p][..., None, :].expand(b, h, d, d)[..., mine], c_el,
                            comp[p][..., mine])
            fin_t[..., mine] = c_el
        if nc == ranks:                                           # rank 0's (2) in pass 1
            carries[0] = s0_t
        for q, (c0, n) in enumerate(runs):                        # pass 2
            s_t = carries[q]
            for c in range(c0, c0 + n):
                out[:, :, c] = outputs(s_t, c)
                if c < c0 + n - 1:
                    s_t = step(s_t, c)
    out = out.permute(0, 2, 3, 1, 4).reshape(b, nc * RWKV_CHUNK, h, d)
    return out[:, :t].to(r.dtype), final_state
