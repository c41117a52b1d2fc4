"""RecurrentGemma / Griffin recurrent block (RG-LRU + temporal conv): the
twin of the JAX package's ``models/griffin.py``.

Structure (pre-normed input, residual added by the caller):
  branch a: x -> linear -> causal depthwise conv1d (kernel 4) -> RG-LRU
  branch b: x -> linear -> GeLU
  out     : (a * b) -> linear

RG-LRU:  a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t)),
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_i x_t) * x_t)
Gates use block-diagonal weights (NUM_BLOCKS blocks), as in the paper.

Decode state per layer:
  ``conv``  (B, K-1, w) in the model dtype — trailing conv window
  ``h``     (B, w) f32 — recurrent state

The casts are the JAX package's: Lambda stays f32 whatever the model's
dtype, the gates go through sigmoid in f32, and the decay is rounded to the
model dtype before the scan (in bf16 a decay near 0.999 rounds to 1.0, whose
input term sqrt(1 - a^2) is then 0: the reference's behaviour, kept).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.registry import ModelConfig
from repro_torch.distributed.sharding import unflatten_last
from repro_torch.kernels import ops
from repro_torch.models.params import boxed_normal, boxed_value, boxed_zeros

CONV_K = 4
NUM_BLOCKS = 8
C_RGLRU = 8.0
#: leaves kept in f32 whatever the model's dtype
F32_LEAVES = ("lam",)


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32,
               device="cuda") -> dict:
    d, w = cfg.d_model, _width(cfg)
    bs = w // NUM_BLOCKS
    s = d ** -0.5
    # Lambda such that softplus(Lambda) gives a decay a in [0.9, 0.999]^(1/c)
    # (on the meta device nothing is drawn)
    if torch.device(device).type == "meta":
        lam0 = torch.empty((w,), device="meta")
    else:
        u = torch.rand((w,), generator=gen, device=gen.device) * (0.999 - 0.9) + 0.9
        lam0 = torch.log(torch.expm1(-torch.log(u) / C_RGLRU))
    normal = lambda shape, axes, scale: boxed_normal(gen, shape, axes, scale, dtype, device)
    return {
        "wx": normal((d, w), ("embed", "ff"), s),
        "wgate": normal((d, w), ("embed", "ff"), s),
        "conv_w": normal((CONV_K, w), (None, "ff"), 0.5),
        "conv_b": boxed_zeros((w,), ("ff",), dtype, device),
        "gate_a": normal((NUM_BLOCKS, bs, bs), (None, "ff", None), bs ** -0.5),
        "gate_i": normal((NUM_BLOCKS, bs, bs), (None, "ff", None), bs ** -0.5),
        "lam": boxed_value(lam0.to(device=device, dtype=torch.float32), ("ff",)),
        "wo": normal((w, d), ("ff", "embed"), w ** -0.5),
    }


def param_count(cfg: ModelConfig) -> int:
    """Elements of ``init_rglru``, from shapes alone."""
    d, w = cfg.d_model, _width(cfg)
    bs = w // NUM_BLOCKS
    return 3 * d * w + CONV_K * w + w + 2 * NUM_BLOCKS * bs * bs + w


def _block_diag(x: torch.Tensor, wblk: torch.Tensor) -> torch.Tensor:
    """(B,T,w) x (NB, bs, bs) -> (B,T,w) block-diagonal matmul."""
    b, t, w = x.shape
    nb, bs, _ = wblk.shape
    yb = torch.einsum("btns,nsc->btnc", unflatten_last(x, nb, bs), wblk)
    return yb.reshape(b, t, w)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d, kernel K, in x's dtype. prev: (B, K-1, w)
    trailing context (None = zeros) -> (out, the new trailing context)."""
    k, t = w.shape[0], x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)                   # (B, T+K-1, w)
    out = sum(xp[:, i:i + t, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :], xp[:, -(k - 1):, :]


def rglru_block(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                  # (B, T, d) pre-normed
    state: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """-> (y (B, T, d), new state {"conv", "h"}); ``state`` is not changed."""
    xa = x @ p["wx"]
    xb = F.gelu(x @ p["wgate"], approximate="tanh")   # jax.nn.gelu's default

    xa, conv_new = _causal_conv(xa, p["conv_w"], p["conv_b"],
                                state["conv"] if state is not None else None)

    r = torch.sigmoid(_block_diag(xa, p["gate_a"]).float())
    i = torch.sigmoid(_block_diag(xa, p["gate_i"]).float())
    a = torch.exp(-C_RGLRU * F.softplus(p["lam"].float()) * r)    # (B,T,w) in (0,1)

    gated = (i * xa.float()).to(x.dtype)
    h, h_last = ops.rglru(gated, a.to(x.dtype), state["h"] if state is not None else None)

    y = (h.to(x.dtype) * xb) @ p["wo"]
    return y, {"conv": conv_new, "h": h_last}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = _width(cfg)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
