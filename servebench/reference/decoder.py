"""Plain float32 reference of the served decoder (attention and a dense or
MoE SwiGLU feed-forward), teacher-forced over a prompt and the tokens the
program served.

Written from the configuration's equations, not from the port: token
embedding, then per layer a pre-norm (RMSNorm, eps 1e-6, scale) GQA
causal self-attention with split-half rotary positions on q and k (and
q/k/v biases where the configuration has them), a residual, a pre-norm
feed-forward and a residual; a final norm and logits x W_out^T / sqrt(d).
The MoE feed-forward routes in f32: top-k of the router logits, softmax
over the k chosen, the chosen experts' SwiGLU weighted by their gates.
Capacity: the tokens that one call of the layer routes together share
``capacity`` rows an expert, taken in token order (token-major, then the
k choices); the rest are dropped.  A batch-1 prefill routes the prompt
together; each later position is routed on its own here (one token never
fills a capacity of at least 8), so a decode step's drops, which depend
on the other slots' tokens, are not reproduced (see PERF.md).

Computed layer by layer, each layer's weights upcast from the served
tensors only while it runs, attention in blocks of query rows, with TF32
off.  ``precision="fp8"`` is the control: every weight product with both
operands rounded to float8 e4m3 under a per-tensor scale (the router
stays f32), which is the step below the served bfloat16.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

EPS = 1e-6
Q_BLOCK = 512
FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(a) @ _fp8(b)
    return a @ b


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd): the first half rotated against the second."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos.float()[:, None, None] * inv
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(cfg: Dict, p: Dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    s, d = h.shape
    nq, nkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["head_dim"] or d // nq
    q = _mm(h, p["wq"].float().reshape(d, nq * hd), precision).view(s, nq, hd)
    k = _mm(h, p["wk"].float().reshape(d, nkv * hd), precision).view(s, nkv, hd)
    v = _mm(h, p["wv"].float().reshape(d, nkv * hd), precision).view(s, nkv, hd)
    if cfg.get("qkv_bias"):
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    pos = torch.arange(s, device=h.device)
    q, k = _rope(q, pos, cfg["rope_theta"]), _rope(k, pos, cfg["rope_theta"])
    g = nq // nkv
    kt = k.permute(1, 2, 0)                       # (nkv, hd, S)
    vh = v.permute(1, 0, 2)                       # (nkv, S, hd)
    out = torch.empty(s, nq, hd, device=h.device)
    for lo in range(0, s, Q_BLOCK):
        hi = min(lo + Q_BLOCK, s)
        qb = q[lo:hi].view(hi - lo, nkv, g, hd).permute(1, 2, 0, 3)   # (nkv, g, b, hd)
        sc = (qb @ kt[:, None]) * hd ** -0.5                          # (nkv, g, b, S)
        mask = torch.arange(s, device=h.device)[None, :] > torch.arange(lo, hi, device=h.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        ob = torch.softmax(sc, dim=-1) @ vh[:, None]                  # (nkv, g, b, hd)
        out[lo:hi] = ob.permute(2, 0, 1, 3).reshape(hi - lo, nq, hd)
    return _mm(out.reshape(s, nq * hd), p["wo"].float().reshape(nq * hd, d), precision)


def _swiglu(x, wg, wu, wo, precision):
    h = torch.nn.functional.silu(_mm(x, wg.float(), precision)) * _mm(x, wu.float(), precision)
    return _mm(h, wo.float(), precision)


def _moe(cfg: Dict, p: Dict, h: torch.Tensor, group: int, precision: str) -> torch.Tensor:
    """The MoE layer over h (S, d); the first ``group`` tokens are routed
    together under one capacity, each later token on its own."""
    s, d = h.shape
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    logits = h @ p["router"].float()
    top_v, top_i = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    keep = torch.ones_like(gates, dtype=torch.bool)
    if group:
        c = int(group * k * cfg["moe_capacity_factor"] / e) + 1
        c = max(8, -(-c // 8) * 8)
        onehot = torch.nn.functional.one_hot(top_i[:group].reshape(-1), e)     # (group k, E)
        rank = (onehot.cumsum(0) - 1).gather(1, top_i[:group].reshape(-1, 1))[:, 0]
        keep[:group] = (rank < c).view(group, k)
    y = torch.zeros(s, d, device=h.device)
    for ex in range(e):
        tok, slot = torch.nonzero((top_i == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(h[tok], p["wi_gate"][ex], p["wi_up"][ex], p["wo"][ex], precision)
        y.index_add_(0, tok, gates[tok, slot, None] * out)
    return y


def logits_at(cfg: Dict, params: Dict, tokens: torch.Tensor, prompt_len: int,
              positions: Sequence[int], *, precision: str = "f32") -> torch.Tensor:
    """f32 logits (len(positions), vocab) at ``positions`` of the sequence
    ``tokens`` (S,), the first ``prompt_len`` of which were prefilled
    together."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(cfg, params, tokens, prompt_len, positions, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def _logits_at(cfg, params, tokens, prompt_len, positions, precision):
    x = params["embed"][tokens.long()].float()
    for p in params["layers"]:
        x = x + _attention(cfg, p["attn"], _rms(x, p["norm1"]["scale"]), precision)
        h = _rms(x, p["norm2"]["scale"])
        if "moe" in p:
            x = x + _moe(cfg, p["moe"], h, prompt_len, precision)
        else:
            m = p["mlp"]
            x = x + _swiglu(h, m["wi_gate"], m["wi_up"], m["wo"], precision)
    h = _rms(x[torch.as_tensor(list(positions), device=x.device)], params["final_norm"]["scale"])
    head = params["embed"] if cfg.get("tie_embeddings") else params["lm_head"]
    out = torch.empty(h.shape[0], head.shape[0], device=h.device)
    rows = 1 << 15
    for lo in range(0, head.shape[0], rows):
        out[:, lo:lo + rows] = _mm(h, head[lo:lo + rows].float().T, precision)
    return out * cfg["d_model"] ** -0.5
