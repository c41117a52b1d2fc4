"""Plain PyTorch versions of the kernels (attention and the RWKV-6 scan),
the RG-LRU's sequential oracle, and the one-bf16-step bound (with its
large-output inputs) that the bf16 flash kernel is held to.

These are (1) the path ``ops`` takes for tensors on the CPU, and (2) the
oracles every CUDA kernel is held against on the card (``chip_smoke.py``).
They keep the arithmetic of the JAX oracles (``repro/kernels/ref.py``):
logits and softmax in f32 from the inputs' own values, probabilities cast
to v's dtype before the PV product, which accumulates in f32, and the
output cast to q's dtype.  Upcasting a bf16 operand to f32 is exact, so an
f32 product of upcast operands is JAX's ``preferred_element_type=f32``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def _softmax_pv(logits: torch.Tensor, v_dtype: torch.dtype) -> torch.Tensor:
    """softmax in f32, then probs rounded to v's dtype and returned as f32."""
    probs = torch.softmax(logits, dim=-1)
    return probs.to(v_dtype).float()


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
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = _softmax_pv(logits, v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, sq, nq, hd).to(q.dtype)


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


def split_ranges(s: int, splits: int, chunk: int) -> List[Tuple[int, int]]:
    """The ``[start, end)`` cache slots of each split of split-S decode:
    ``chunk`` slots each, the last split up to ``s``."""
    return [(i * chunk, s if i == splits - 1 else (i + 1) * chunk) for i in range(splits)]


def decode_attention_split_reference(
    q: torch.Tensor,                 # (B, nq, hd)
    k_cache: torch.Tensor,           # (B, S, nkv, hd)
    v_cache: torch.Tensor,           # (B, S, nkv, hd)
    valid: torch.Tensor,             # (B, S) bool
    splits: int,
    chunk: Optional[int] = None,     # slots per split; default S // splits
) -> torch.Tensor:
    """Split-and-combine decode, the arithmetic of ``csrc/decode_attention.cu``.

    Split ``i`` owns slots ``[i * chunk, (i + 1) * chunk)``, the last one up
    to S.  Each split keeps its running max m, sum l and unnormalised
    accumulator a per query head (a split with no valid slot: m = -1e30,
    l = 0, a = 0); the combine weighs split i by exp(m_i - max m) where
    l_i > 0 and divides by the weighted sum.  A sequence with no valid slot
    gives 0, as the kernels do.  Nothing on the main path calls it; the
    tests hold it to the JAX oracle.  Returns (B, nq, hd) in q's dtype."""
    b, nq, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    chunk = s // splits if chunk is None else chunk
    if not (1 <= splits and 1 <= chunk and (splits - 1) * chunk < s):
        raise ValueError(f"{splits} splits of {chunk} slots do not cut {s} slots")
    qg = q.reshape(b, nkv, nq // nkv, hd).float()
    ms, ls, accs = [], [], []
    for lo, hi in split_ranges(s, splits, chunk):
        logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache[:, lo:hi].float()) * hd ** -0.5
        ok = valid[:, None, None, lo:hi]
        logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
        m = logits.amax(dim=-1)                                     # (B, nkv, g)
        p = torch.where(ok, torch.exp(logits - m[..., None]), torch.zeros_like(logits))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskh->bkgh", p, v_cache[:, lo:hi].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.where(l > 0, torch.exp(m - m.amax(dim=0)), torch.zeros_like(m))
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


# The chunk-parallel form of ``csrc/rwkv6_scan.cu``'s bf16 prefill: chunks of
# RWKV_CHUNK tokens, each split at its middle into two sub-chunks.
RWKV_CHUNK = 32
RWKV_SUB = RWKV_CHUNK // 2
# the smallest decay, as the TPU kernel clamps it: keeps log2 finite at w = 0
RWKV_W_MIN = 1e-38


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
    """The chunk-parallel arithmetic of ``csrc/rwkv6_scan.cu``'s bf16 prefill.

    Per chunk of C = 32 tokens, in the exponents of ``rwkv6_chunk_exponents``:
      A[t,s]  = sum_i r_ti k_si 2^(P[t,i] - P[s+1,i]), s < t:
                pairwise where s and t share a sub-chunk; for t >= e > s the
                product (r_t 2^(P[t]-P[e])) . (k_s 2^(P[e]-P[s+1]));
      o_t     = sum_s A[t,s] v_s + ((r_t u) . k_t) v_t + (r_t 2^P[t]) S_{c-1};
      dS_c    = sum_s (k_s 2^(P[L]-P[s+1])) v_s^T,   S_c = 2^P[L] S_{c-1} + dS_c,
    the carry S_c the only serial step.  Everything is f32: the kernel gives
    the tensor cores each f32 operand as three bf16 parts (24 significant
    bits in all), so its products keep f32's precision.  Nothing on the main
    path calls it: the tests hold it to the JAX oracle.  Returns (out
    (B, T, H, hd) in r's dtype, final state (B, H, hd, hd) f32)."""
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
