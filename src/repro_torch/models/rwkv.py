"""RWKV-6 "Finch" block — attention-free, data-dependent decay.

Two sub-blocks, each called by the model on a pre-normed input and added
residually (standard RWKV structure):

* ``time_mix``    — token-shift mixing, r/k/v/g projections, decay ``w_t``
  from a low-rank MLP (the Finch innovation), matrix-valued per-head WKV
  state with bonus ``u``, through ``ops.rwkv6`` (the CUDA kernel on the
  card).
* ``channel_mix`` — token-shift + squared-ReLU FFN with sigmoid gate.

Decode state per layer:
  ``shift_tm`` (B, d)        — previous (normed) token for time-mix shift
  ``shift_cm`` (B, d)        — previous (normed) token for channel-mix shift
  ``wkv``      (B, H, hd, hd) fp32 — recurrent state
Token-shift states hold the *normed* inputs, so prefill and decode agree.
The casts are the JAX package's: ``mu``, ``w0``, ``u`` and ``cm_mu`` stay
f32 whatever the model's dtype, the decay is computed in f32 and cast to
x's dtype before the scan.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.registry import ModelConfig
from repro_torch.distributed.sharding import unflatten_last
from repro_torch.kernels import ops
from repro_torch.models.params import boxed_normal, boxed_zeros

DECAY_LORA_RANK = 96
#: leaves kept in f32 whatever the model's dtype
F32_LEAVES = ("mu", "w0", "u", "cm_mu")


def init_rwkv(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32,
              device="cuda") -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    s = d ** -0.5
    r = DECAY_LORA_RANK
    zeros = lambda shape, axes: boxed_zeros(shape, axes, torch.float32, device)
    normal = lambda shape, axes, scale: boxed_normal(gen, shape, axes, scale, dtype, device)
    return {
        # time-mix
        "mu": zeros((5, d), (None, "embed")),   # r,k,v,w,g shifts
        "wr": normal((d, d), ("embed", "heads_flat"), s),
        "wk": normal((d, d), ("embed", "heads_flat"), s),
        "wv": normal((d, d), ("embed", "heads_flat"), s),
        "wg": normal((d, d), ("embed", "heads_flat"), s),
        "wo": normal((d, d), ("heads_flat", "embed"), s),
        "decay_a": normal((d, r), ("embed", None), s),
        "decay_b": normal((r, d), (None, "heads_flat"), r ** -0.5),
        "w0": zeros((d,), ("heads_flat",)),
        "u": zeros((h, hd), ("heads_flat", None)),
        # channel-mix
        "cm_mu": zeros((d,), ("embed",)),
        "cm_k": normal((d, cfg.d_ff), ("embed", "ff"), s),
        "cm_v": normal((cfg.d_ff, d), ("ff", "embed"), cfg.d_ff ** -0.5),
        "cm_r": normal((d, d), ("embed", "embed_out"), s),
    }


def param_count(cfg: ModelConfig) -> int:
    """Elements of ``init_rwkv``, from shapes alone."""
    d, ff = cfg.d_model, cfg.d_ff
    r = DECAY_LORA_RANK
    return 5 * d + 5 * d * d + 2 * d * r + d + d + d + 2 * d * ff + d * d


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """shifted[t] = x[t-1]; shifted[0] = prev (or 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(w0 + tanh(x A) B)), in f32."""
    lora = xw.float() @ p["decay_a"].float()
    logw = p["w0"] + torch.tanh(lora) @ p["decay_b"].float()
    return torch.exp(-torch.exp(torch.clamp(logw, -8.0, 4.0)))


def time_mix(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                         # (B, T, d) — pre-normed
    shift_prev: Optional[torch.Tensor],      # (B, d) or None
    wkv0: Optional[torch.Tensor],            # (B, H, hd, hd) f32 or None
    *,
    wkv_out: Optional[torch.Tensor] = None,  # receives the final state (may be wkv0)
):
    """-> (y (B, T, d), new time-mix shift (B, d), final wkv state)."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd

    delta = _token_shift(x, shift_prev) - x
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = [x + delta * mu[i] for i in range(5)]
    r = unflatten_last(xr @ p["wr"], h, hd)
    k = unflatten_last(xk @ p["wk"], h, hd)
    v = unflatten_last(xv @ p["wv"], h, hd)
    g = xg @ p["wg"]
    w = unflatten_last(_decay(p, xw), h, hd).to(x.dtype)

    out, wkv = ops.rwkv6(r, k, v, w, p["u"], wkv0, final_state=wkv_out)   # (B,T,H,hd)
    out = out.reshape(b, t, d) * F.silu(g)
    y = out @ p["wo"]
    return y, x[:, -1, :], wkv


def channel_mix(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                         # (B, T, d) — pre-normed
    shift_prev: Optional[torch.Tensor],
):
    """-> (y (B, T, d), new channel-mix shift (B, d))."""
    shifted = _token_shift(x, shift_prev)
    xk = x + (shifted - x) * p["cm_mu"].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p["cm_k"]))
    vv = kk @ p["cm_v"]
    rr = torch.sigmoid(x @ p["cm_r"])
    return rr * vv, x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return {
        "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
    }
