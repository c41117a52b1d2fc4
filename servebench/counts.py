"""FLOPs and bytes of the served calls, from the shapes the benchmark sent,
and the H100's peaks.  Frozen here: the program's own count
(``repro_torch.launch.dryrun.analytic_flops``) may change, this one may not.

A FLOP is one multiply or one add (2 a multiply-add).  Counts cover what
the inputs need: each token through its top-k experts (not the capacity's
rows), the visible (query, key) pairs of a causal prefill, the live slots
of a decode step and their valid cache positions (the engine decodes its
free slots too, which no request needs), and the vocabulary only where
logits are made (the last prompt token of a prefill, every live slot of a
decode step).
Options reproduce what the plain CPU versions compute, for the tests that
hold these counts to ``torch.utils.flop_counter.FlopCounterMode``.

``cfg`` is a configuration file's dict (``configs/<config>.json``).
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(cfg: Dict) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]


def _attn_linear(cfg: Dict) -> int:
    """Weights of one layer's q, k, v and o projections."""
    d, hd = cfg["d_model"], head_dim(cfg)
    return d * hd * (2 * cfg["num_heads"] + 2 * cfg["num_kv_heads"])


def _expert(cfg: Dict) -> int:
    return 3 * cfg["d_model"] * (cfg.get("expert_d_ff") or cfg["d_ff"])


def capacity(cfg: Dict, tokens: int) -> int:
    """Rows an expert takes for ``tokens`` routed together: capacity factor
    x the mean load, plus one, rounded up to a multiple of 8, at least 8."""
    c = int(tokens * cfg["num_experts_per_tok"] * cfg["moe_capacity_factor"]
            / cfg["num_experts"]) + 1
    return max(8, -(-c // 8) * 8)


def _ffn_flops(cfg: Dict, tokens: int, experts: str) -> int:
    d = cfg["d_model"]
    if not cfg.get("num_experts"):
        return 2 * tokens * 3 * d * cfg["d_ff"]
    router = 2 * tokens * d * cfg["num_experts"]
    if experts == "capacity":
        rows = cfg["num_experts"] * capacity(cfg, tokens)
    else:
        rows = tokens * cfg["num_experts_per_tok"]
    return router + 2 * rows * _expert(cfg)


def prefill_flops(cfg: Dict, s: int, *, attention: str = "causal",
                  experts: str = "topk") -> int:
    """One batch-1 prefill of ``s`` tokens: every layer, and the logits of
    the last token.  ``attention="full"`` counts every (query, key) pair and
    ``experts="capacity"`` every capacity row, as the plain CPU path
    computes them."""
    hd, nq = head_dim(cfg), cfg["num_heads"]
    pairs = s * (s + 1) // 2 if attention == "causal" else s * s
    layer = 2 * s * _attn_linear(cfg) + 4 * hd * nq * pairs + _ffn_flops(cfg, s, experts)
    return cfg["num_layers"] * layer + 2 * cfg["d_model"] * cfg["vocab_size"]


def decode_flops(cfg: Dict, slots: int, valid: int, *, experts: str = "topk") -> int:
    """One decode step over ``slots`` sequences (the live ones) whose
    attention sees ``valid`` cache positions in all (per layer), with each
    one's logits."""
    hd, nq = head_dim(cfg), cfg["num_heads"]
    layer = 2 * slots * _attn_linear(cfg) + 4 * hd * nq * valid + _ffn_flops(cfg, slots, experts)
    return cfg["num_layers"] * layer + 2 * slots * cfg["d_model"] * cfg["vocab_size"]


def experts_reached(cfg: Dict, tokens: int) -> float:
    """Expected experts that ``tokens`` tokens reach, each choosing k of E
    at random: E (1 - (1 - k/E)^tokens).  Routing is data-dependent; the
    count assumes uniform choices."""
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def decode_bytes(cfg: Dict, slots: int, valid: int) -> float:
    """Least bytes a decode step over ``slots`` live sequences moves: every
    weight it needs read once (the router in f32; the experts its tokens
    reach), each sequence's embedding row, the ``valid`` K/V positions read
    and one K/V row a sequence written in every layer."""
    w = BYTES[cfg["dtype"]]
    d, hd, nkv = cfg["d_model"], head_dim(cfg), cfg["num_kv_heads"]
    layer = _attn_linear(cfg) * w + 2 * d * w
    if cfg.get("qkv_bias"):
        layer += hd * (cfg["num_heads"] + 2 * nkv) * w
    if cfg.get("num_experts"):
        layer += d * cfg["num_experts"] * 4 + experts_reached(cfg, slots) * _expert(cfg) * w
    else:
        layer += 3 * d * cfg["d_ff"] * w
    kv = 2 * nkv * hd * w * (valid + slots)
    # the unembedding read whole, each slot's embedding row, the final norm
    rest = cfg["vocab_size"] * d * w + slots * d * w + d * w
    return cfg["num_layers"] * (layer + kv) + rest


def flash_call(cfg: Dict, s: int):
    """(FLOPs, bytes) of one causal flash-attention call over ``s`` tokens:
    the visible pairs; q, k, v read once and o written once."""
    hd, nq, nkv = head_dim(cfg), cfg["num_heads"], cfg["num_kv_heads"]
    w = BYTES[cfg["dtype"]]
    return 4 * hd * nq * s * (s + 1) // 2, (2 * s * nq * hd + 2 * s * nkv * hd) * w


def decode_attention_call(cfg: Dict, slots: int, valid: int):
    """(FLOPs, bytes) of one decode-attention call over ``slots`` live
    sequences: their q read and o written, and the K/V rows of their
    ``valid`` cache positions."""
    hd, nq, nkv = head_dim(cfg), cfg["num_heads"], cfg["num_kv_heads"]
    w = BYTES[cfg["dtype"]]
    return 4 * hd * nq * valid, 2 * slots * nq * hd * w + 2 * valid * nkv * hd * w


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline's bound: the larger of FLOPs over the bf16 peak and
    bytes over the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
