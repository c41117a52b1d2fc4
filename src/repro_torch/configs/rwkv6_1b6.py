"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892] — 24 layers, d_model 2048, channel-mix hidden 7168,
vocab 65536, head_dim 64 (32 heads of the matrix-valued WKV state).
"""
from repro_torch.configs.registry import RWKV, ModelConfig, register


@register("rwkv6-1.6b")
def rwkv6() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,           # wkv heads = d_model / rwkv_head_dim
        num_kv_heads=32,
        d_ff=7168,              # channel-mix hidden
        vocab_size=65536,
        block_pattern=(RWKV,),
        rwkv_head_dim=64,
        mlp="gelu",             # channel-mix uses squared-relu-ish; gelu stand-in
        norm="layernorm",
        quality=0.46,           # paper avg benchmark (1.6B scale)
        source="arXiv:2404.05892",
    )
