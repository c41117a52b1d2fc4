"""Qwen2-72B — large dense, GQA with QKV bias.

[arXiv:2407.10671] — 80 layers, d_model 8192, 64 heads (GQA kv=8),
d_ff 29568, vocab 152064, QKV bias.
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("qwen2-72b")
def qwen2_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        block_pattern=(ATTN,),
        rope_theta=1_000_000.0,
        mlp="swiglu",
        norm="rmsnorm",
        quality=0.842,          # paper MMLU
        source="arXiv:2407.10671",
    )
