from repro_torch.models.model import (  # noqa: F401
    init_params,
    forward,
    prefill,
    decode_step,
    init_cache,
    param_count,
)
