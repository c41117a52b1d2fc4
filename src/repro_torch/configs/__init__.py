"""Architecture configs. ``get_config(name)`` is the public entry point."""
from repro_torch.configs.registry import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    list_architectures,
)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        phi35_moe,
        rwkv6_1b6,
        llava_next_mistral_7b,
        minicpm_2b,
        qwen2_72b,
        qwen15_0b5,
        recurrentgemma_9b,
        whisper_small,
        kimi_k2,
        llama3_8b,
    )
