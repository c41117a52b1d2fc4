"""Qwen1.5-0.5B — small dense with QKV bias (MHA: kv == heads).

[hf:Qwen/Qwen1.5-0.5B] — 24 layers, d_model 1024, 16 heads (kv=16),
d_ff 2816, vocab 151936.
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("qwen1.5-0.5b")
def qwen15_0b5() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        block_pattern=(ATTN,),
        mlp="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        quality=0.393,          # model-card MMLU
        source="hf:Qwen/Qwen1.5-0.5B",
    )
