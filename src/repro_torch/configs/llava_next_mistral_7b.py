"""LLaVA-NeXT (v1.6) Mistral-7B backbone — anyres tiling VLM.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] — language backbone: 32 layers,
d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 32000.  The vision
tower (CLIP ViT-L + anyres tiling + projector) is a frontend STUB:
``input_specs`` supplies precomputed patch+text embeddings (B, S, d_model).
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("llava-next-mistral-7b")
def llava_next() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        block_pattern=(ATTN,),
        frontend="vision",
        mlp="swiglu",
        norm="rmsnorm",
        quality=0.625,          # mistral-7b base MMLU (pool-comparable scale)
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
