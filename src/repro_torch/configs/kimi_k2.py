"""Kimi K2 — trillion-parameter MoE (1T total / 32B active), paper-table config.

[arXiv:2501.kimi2] — 61 layers, d_model 7168, 64 heads (GQA kv=8),
per-expert FFN 2048, vocab 163840, 384 experts top-8.
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=112,
        d_ff=2048,
        expert_d_ff=2048,
        vocab_size=163840,
        num_experts=384,
        num_experts_per_tok=8,
        block_pattern=(ATTN,),
        mlp="swiglu",
        norm="rmsnorm",
        quality=0.875,          # paper-table MMLU
        source="arXiv:2501.kimi2",
    )
