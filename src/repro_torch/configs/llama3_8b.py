"""Llama-3-8B — dense GQA reference with 128k vocab.

[arXiv:2407.21783] — 32 layers, d_model 4096, 32 heads (GQA kv=8),
d_ff 14336, vocab 128256.
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("llama3-8b")
def llama3_8b() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        block_pattern=(ATTN,),
        rope_theta=500_000.0,
        mlp="swiglu",
        norm="rmsnorm",
        quality=0.663,          # paper MMLU (8B base)
        source="arXiv:2407.21783",
    )
