"""MiniCPM-2B — llama-like dense model trained with the WSD schedule.

[arXiv:2404.06395] — 40 layers, d_model 2304, 36 heads (kv=36, i.e. MHA),
d_ff 5760, vocab 122753.  The WSD (warmup-stable-decay) schedule is
implemented in ``repro.training.schedule`` and exercised by the training
example.
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("minicpm-2b")
def minicpm() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        block_pattern=(ATTN,),
        mlp="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,    # MiniCPM ties embeddings
        quality=0.536,          # paper MMLU
        source="arXiv:2404.06395",
    )
