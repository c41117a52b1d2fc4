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

DTensors (a partitioned step, ``distributed/sharding.py``).  DTensor has
no sharding rule for a kernel, so each wrapper reaches the kernel (or, on
the CPU and meta, the plain version) through ``local_map``, which hands it
every rank's local tensors.  The placements each kernel takes: batch and
heads may be ``Shard`` (over the mesh dimensions the query's are), and
anything else is redistributed to ``Replicate`` first, an all-gather: the
sequence, the head dim, a decode cache's ``kv_seq`` (the reference's
flash-decode split-K, which would need a log-sum-exp merge across ranks)
and partial sums.  Under GQA with the query heads sharded and the KV heads
not (``make_rules`` maps ``heads`` and ``kv_heads`` each on its own, so 32
query heads shard over 16 ranks and 8 KV heads do not), the KV heads stay
replicated and each rank takes the ones its query heads use
(``kv_heads_of``).  The autograd Functions run inside ``local_map``, so a
gradient comes back as a DTensor.

The RG-LRU recurrence has no kernel: the JAX package runs it as an XLA
associative scan for every ``impl``, and ``rglru`` here is the same
log-depth scan in PyTorch ops on any device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import local_call

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


# ---------------------------------------------------------------------------
# DTensor inputs: the kernels through local_map.
# ---------------------------------------------------------------------------
def _kept(t: DTensor, keep: Sequence[int]) -> tuple:
    """``t``'s placement on each mesh dimension where it shards one of the
    tensor dims ``keep``, ``Replicate()`` elsewhere."""
    return tuple(pl if isinstance(pl, Shard) and pl.dim in keep else Replicate()
                 for pl in t.placements)


def _mapped(pl: Sequence, dims: dict) -> tuple:
    """Placements with each ``Shard(d)`` moved to ``Shard(dims[d])`` (or
    ``Replicate()`` where ``dims`` maps ``d`` to None)."""
    out = []
    for p in pl:
        d = dims.get(p.dim) if isinstance(p, Shard) else None
        out.append(Shard(d) if d is not None else Replicate())
    return tuple(out)


def _shard_index(mesh, pl: Sequence, dim: int) -> Tuple[int, int]:
    """(this rank's index, shard count) along tensor dim ``dim`` under the
    placements ``pl``: the mesh dimensions that shard it, major to minor."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for m, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            idx, n = idx * mesh.size(m) + coord[m], n * mesh.size(m)
    return idx, n


def kv_heads_of(q_start: int, nq_loc: int, nq: int, nkv: int):
    """The KV heads the query heads ``q_start .. q_start + nq_loc`` use under
    GQA (query head h uses KV head ``h // (nq / nkv)``), as what a local
    call needs: a slice ``(start, stop)`` of KV heads that pairs with the
    query heads in the kernel's own GQA order, or, where no slice does, a
    list of one KV head a query head (a group of one)."""
    group = nq // nkv
    first, last = q_start // group, (q_start + nq_loc - 1) // group
    n_kv = last - first + 1
    if nq_loc % n_kv == 0 and all((q_start + i) // group - first == i // (nq_loc // n_kv)
                                  for i in range(nq_loc)):
        return first, last + 1
    return [(q_start + i) // group for i in range(nq_loc)]


def _take_kv(kv: torch.Tensor, heads, dim: int) -> torch.Tensor:
    if isinstance(heads, tuple):
        return kv.narrow(dim, heads[0], heads[1] - heads[0])
    return kv.index_select(dim, torch.tensor(heads, device=kv.device))


def _gqa_placements(q: DTensor, q_heads: int, kv: DTensor, kv_heads: int):
    """Placements for q and its K/V (or cache) under ``local_map``: q keeps
    its batch and head shards; K/V shard their batch where q does and
    their heads where q's heads are and theirs are too, else stay
    replicated there.  Returns (q placements, kv placements, whether the
    local call must take its KV heads by ``kv_heads_of``)."""
    q_pl = _kept(q, (0, q_heads))
    kv_pl, select = [], False
    for q_p, kv_p in zip(q_pl, kv.placements):
        if isinstance(q_p, Shard) and q_p.dim == 0:
            kv_pl.append(Shard(0))
        elif isinstance(q_p, Shard) and isinstance(kv_p, Shard) and kv_p.dim == kv_heads:
            kv_pl.append(Shard(kv_heads))
        else:
            kv_pl.append(Replicate())
            select = select or isinstance(q_p, Shard)
    return q_pl, tuple(kv_pl), select


def _kv_grad_placements(q_pl, kv_pl) -> tuple:
    """K/V's gradient placements under ``local_map``: where the query heads
    are split and the KV heads replicated, each rank's gradient of the
    whole K/V holds only its query heads' part, a ``Partial`` sum."""
    return tuple(Partial() if isinstance(q_p, Shard) and q_p.dim != 0
                 and not isinstance(kv_p, Shard) else kv_p for q_p, kv_p in zip(q_pl, kv_pl))


def _local_kv(mesh, q_pl, q_heads: int, nq: int, nkv: int):
    """What ``_take_kv`` takes on this rank: the KV heads its query heads use."""
    idx, n = _shard_index(mesh, q_pl, q_heads)
    return kv_heads_of(idx * (nq // n), nq // n, nq, nkv)


def _flash_dtensor(q, k, v, causal, window, q_offset):
    mesh = q.device_mesh
    q_pl, kv_pl, select = _gqa_placements(q, 2, k, 2)
    heads = _local_kv(mesh, q_pl, 2, q.shape[2], k.shape[2]) if select else None

    def local(q_, k_, v_):
        if heads is not None:
            k_, v_ = _take_kv(k_, heads, 2), _take_kv(v_, heads, 2)
        return flash_attention(q_, k_, v_, causal=causal, window=window, q_offset=q_offset)

    kv_grad = _kv_grad_placements(q_pl, kv_pl)
    return local_call(local, mesh, (q_pl, kv_pl, kv_pl), q_pl, q, k, v,
                      in_grad_placements=(q_pl, kv_grad, kv_grad))


def _decode_dtensor(q, k_cache, v_cache, valid):
    mesh = q.device_mesh
    q_pl, kv_pl, select = _gqa_placements(q, 1, k_cache, 2)
    valid_pl = _mapped(q_pl, {0: 0})
    heads = _local_kv(mesh, q_pl, 1, q.shape[1], k_cache.shape[2]) if select else None

    def local(q_, k_, v_, valid_):
        if heads is not None:
            k_, v_ = _take_kv(k_, heads, 2), _take_kv(v_, heads, 2)
        return decode_attention(q_, k_, v_, valid_)

    return local_call(local, mesh, (q_pl, kv_pl, kv_pl, valid_pl), q_pl,
                      q, k_cache, v_cache, valid)


def _rwkv_dtensor(r, k, v, w, u, state, final_state):
    mesh = r.device_mesh
    x_pl = _kept(r, (0, 2))
    u_pl = _mapped(x_pl, {2: 0})
    s_pl = _mapped(x_pl, {0: 0, 2: 1})
    in_place = final_state is not None and tuple(final_state.placements) == s_pl
    # u has no batch dim: where the batch is split, each rank's gradient of
    # it is its sequences' part, a partial sum
    u_grad = tuple(Partial() if isinstance(x, Shard) and x.dim == 0 else p
                   for x, p in zip(x_pl, u_pl))
    args = [r, k, v, w, u]
    in_pl, grad_pl = [x_pl] * 4 + [u_pl], [x_pl] * 4 + [u_grad]
    if state is not None:
        args.append(state)
        in_pl.append(s_pl)
        grad_pl.append(s_pl)
    if in_place:
        args.append(final_state)
        in_pl.append(s_pl)
        grad_pl.append(s_pl)

    def local(*ts):
        r_, k_, v_, w_, u_ = ts[:5]
        st = ts[5] if state is not None else None
        fs = ts[-1] if in_place else None
        return rwkv6(r_, k_, v_, w_, u_, st, final_state=fs)

    out, s = local_call(local, mesh, in_pl, (x_pl, s_pl), *args, in_grad_placements=grad_pl)
    if final_state is not None and not in_place:
        s = final_state.copy_(s)
    return out, s


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Full-sequence attention (B,Sq,nq,hd)x(B,Sk,nkv,hd)->(B,Sq,nq,hd)."""
    if isinstance(q, DTensor):
        return _flash_dtensor(q, k, v, causal, window, q_offset)
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
    if isinstance(q, DTensor):
        return _decode_dtensor(q, k_cache, v_cache, valid)
    if _device_type(q) == "cuda":
        return _da.decode_attention(q, k_cache, v_cache, valid)
    return ref.decode_attention_reference(q, k_cache, v_cache, valid)


def rwkv6(r, k, v, w, u, state=None, *, final_state=None):
    """RWKV-6 WKV recurrence (B,T,H,hd) -> (out, final state f32).

    ``final_state``, when given, receives the final state (it may be
    ``state`` itself: the decode cache is updated in place; no gradient
    flows through that call on the card)."""
    if isinstance(r, DTensor):
        return _rwkv_dtensor(r, k, v, w, u, state, final_state)
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
