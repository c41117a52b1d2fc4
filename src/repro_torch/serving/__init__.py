from repro_torch.serving.engine import Engine, EngineConfig, Request  # noqa: F401
from repro_torch.serving.batching import ContinuousBatcher  # noqa: F401
