"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 2 recurrent : 1 local.

[arXiv:2402.19427] — 38 layers, d_model 4096, 16 heads (GQA kv=1 => MQA),
d_ff 12288, vocab 256000, local attention window 2048.

Pattern: (rglru, rglru, local) repeating; 38 = 12*3 + 2 -> tail (rglru, rglru).
"""
from repro_torch.configs.registry import LOCAL_ATTN, RGLRU, ModelConfig, register


@register("recurrentgemma-9b")
def recurrentgemma() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
        tail_blocks=(RGLRU, RGLRU),
        local_window=2048,
        rglru_width=4096,
        mlp="gelu",             # gated gelu in the paper
        norm="rmsnorm",
        quality=0.607,          # paper MMLU (9B IT)
        source="arXiv:2402.19427",
    )
