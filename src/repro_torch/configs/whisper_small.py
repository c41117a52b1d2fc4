"""Whisper-small — encoder-decoder speech backbone; conv frontend STUBBED.

[arXiv:2212.04356] — 12 encoder + 12 decoder layers, d_model 768,
12 heads (MHA), d_ff 3072, vocab 51865.  ``input_specs`` supplies
precomputed mel+conv frame embeddings (B, 1500, 768) for the encoder.
Decoder context in the real model is <=448 tokens; the assigned decode
shapes are exercised structurally (backbone supports them).
"""
from repro_torch.configs.registry import ATTN, ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        block_pattern=(ATTN,),
        is_encoder_decoder=True,
        encoder_layers=12,
        encoder_seq=1500,
        frontend="audio",
        mlp="gelu",
        norm="layernorm",
        rope_theta=0.0,         # whisper uses learned/sinusoidal abs positions
        quality=0.35,           # capability normalized vs the LM pool
        # (speech specialist; raw 1-WER ~0.91 is not comparable to MMLU)
        source="arXiv:2212.04356",
    )
