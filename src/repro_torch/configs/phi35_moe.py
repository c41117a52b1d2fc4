"""Phi-3.5-MoE-instruct (42B total / 6.6B active).

[hf:microsoft/Phi-3.5-MoE-instruct] — 32 layers, d_model 4096, 32 heads
(GQA kv=8), per-expert FFN 6400, vocab 32064, 16 experts top-2.
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("phi3.5-moe-42b-a6.6b")
def phi35_moe() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6400,
        expert_d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        num_experts_per_tok=2,
        block_pattern=(ATTN,),
        mlp="swiglu",
        norm="rmsnorm",
        quality=0.788,  # model-card MMLU
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )
