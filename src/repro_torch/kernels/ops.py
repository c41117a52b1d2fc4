"""Dispatch of the kernels' hot spots by the device the tensors lie on.

  * a CPU tensor goes to the plain version in ``ref.py``;
  * a CUDA tensor launches the hand-written kernel, which raises on what it
    cannot take: there is no fallback to the plain version;
  * a meta tensor (shapes and dtypes, no values: the dry-run counts a
    step's operations on them, ``launch/dryrun.py``) goes to the plain
    version too, which hides no kernel, since nothing is computed; the WKV
    recurrence takes its chunk-parallel plain form
    (``ref.rwkv6_chunk_parallel_reference``, the scan kernel's chunking
    with f32 products), whose Python loop runs over 32-token chunks, not
    tokens;
  * any other device raises.

Gradients.  On the card, ``flash_attention`` and ``rwkv6`` (without a
``final_state`` to write) run through a ``torch.autograd.Function`` whose
forward is the hand-written kernel and whose backward is the
vector-Jacobian product of the plain version, recomputed from the saved
inputs: the gradient the JAX package takes, which differentiates its jnp
oracles under XLA (no Pallas kernel of it has a backward).  There is no
``impl`` switch.  The kernel wrappers themselves refuse an input that
requires a gradient while grad mode is on (``_build.refuse_grad``), so a
call that no Function covers (``decode_attention``, the scan writing a
decode cache in place) raises instead of returning an output with no
history.  The flash kernel gives 0 for a query row that sees no key, where
the plain version spreads its softmax over the masked keys; the backward
gives such a row a zero gradient, the derivative of the kernel's output.

The RG-LRU recurrence has no kernel: the JAX package runs it as an XLA
associative scan for every ``impl``, and ``rglru`` here is the same
log-depth scan in PyTorch ops on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rwkv


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel path for device {t.device}")
    return t.device.type


def rows_seeing_a_key(sq: int, sk: int, causal: bool, window: int, q_offset: int,
                      device) -> torch.Tensor:
    """(Sq,) bool: which query rows (absolute positions ``q_offset + i``) see
    at least one of the Sk keys under the causal and window masks."""
    if not window:           # q_offset >= 0, so key 0 is always visible
        return torch.ones(sq, dtype=torch.bool, device=device)
    qpos = q_offset + torch.arange(sq, device=device)
    newest = torch.clamp(qpos, max=sk - 1) if causal else torch.full_like(qpos, sk - 1)
    return newest > qpos - window


def _vjp(plain, inputs, needs, grads):
    """Gradients of ``plain(*inputs)`` against ``grads``, recomputed on
    detached inputs; None where ``needs`` is False or the input is None."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(n) if x is not None else None
                  for x, n in zip(inputs, needs)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [x for x in leaves if x is not None and x.requires_grad]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
    return [next(got) if x is not None and x.requires_grad else None for x in leaves]


class _FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the VJP of ``ref.mha_reference``
    under the profiler range ``flash_attention.backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        q, k, v = (x.contiguous() for x in (q, k, v))
        ctx.save_for_backward(q, k, v)
        ctx.opts = {"causal": causal, "window": window, "q_offset": q_offset}
        return _fa.flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention.backward"):
            seen = rows_seeing_a_key(q.shape[1], k.shape[1], device=q.device, **ctx.opts)
            if not bool(seen.all()):
                g = g * seen[None, :, None, None].to(g.dtype)
            plain = lambda q_, k_, v_: ref.mha_reference(q_, k_, v_, **ctx.opts)
            grads = _vjp(plain, (q, k, v), ctx.needs_input_grad[:3], (g,))
        return (*grads, None, None, None)


class _Rwkv6(torch.autograd.Function):
    """Forward: the CUDA scan.  Backward: the VJP of ``ref.rwkv6_reference``
    (output and final state) under the profiler range ``rwkv6.backward``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
        state = state.contiguous() if state is not None else None
        ctx.save_for_backward(r, k, v, w, u, state)
        return _rwkv.rwkv6_scan(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, g_out, g_state):
        with torch.profiler.record_function("rwkv6.backward"):
            grads = _vjp(ref.rwkv6_reference, ctx.saved_tensors, ctx.needs_input_grad,
                         (g_out, g_state))
        return tuple(grads)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Full-sequence attention (B,Sq,nq,hd)x(B,Sk,nkv,hd)->(B,Sq,nq,hd)."""
    if _device_type(q) == "cuda":
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    if (
        causal and window > 0 and q.shape[1] == k.shape[1]
        and q.shape[1] > 2 * window and q_offset == 0
    ):
        # a sliding window pays for itself only computed block-locally:
        # O(S*2W) logits instead of the masked O(S^2)
        return ref.local_attention_blocked(q, k, v, window=window, q_offset=q_offset)
    return ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, valid):
    """Single-token decode attention (B,nq,hd) vs (B,S,nkv,hd)."""
    if _device_type(q) == "cuda":
        return _da.decode_attention(q, k_cache, v_cache, valid)
    return ref.decode_attention_reference(q, k_cache, v_cache, valid)


def rwkv6(r, k, v, w, u, state=None, *, final_state=None):
    """RWKV-6 WKV recurrence (B,T,H,hd) -> (out, final state f32).

    ``final_state``, when given, receives the final state (it may be
    ``state`` itself: the decode cache is updated in place; no gradient
    flows through that call on the card)."""
    if _device_type(r) == "cuda":
        if final_state is None:
            return _Rwkv6.apply(r, k, v, w, u, state)
        return _rwkv.rwkv6_scan(r, k, v, w, u, state, final_state=final_state)
    plain = ref.rwkv6_chunk_parallel_reference if r.device.type == "meta" else ref.rwkv6_reference
    out, s = plain(r, k, v, w, u, state)
    if final_state is None:
        return out, s
    return out, final_state.copy_(s)


def rglru(x, a, h0=None):
    """RG-LRU ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t`` over (B, T, D)
    -> (h in x's dtype, final state (B, D) f32)."""
    return _rglru_assoc(x, a, h0)


def _rglru_assoc(x, a, h0=None):
    """The recurrence as an inclusive scan of the pairs (a_t, b_t) under
    ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``, in f32: ceil(log2 T)
    elementwise steps, each combining every pair with the one ``off``
    steps before it (Hillis-Steele).  ``h0`` is folded into step 0's
    additive term, as the JAX package folds it."""
    a32 = a.float()
    b = torch.sqrt(torch.clamp(1.0 - a32 * a32, min=0.0)) * x.float()
    if h0 is not None:
        b[:, 0] += a32[:, 0] * h0.float()
    t, off = x.shape[1], 1
    while off < t:
        b = torch.cat([b[:, :off], a32[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        if 2 * off < t:      # the last step needs no products of a
            a32 = torch.cat([a32[:, :off], a32[:, :-off] * a32[:, off:]], dim=1)
        off *= 2
    return b.to(x.dtype), b[:, -1]
