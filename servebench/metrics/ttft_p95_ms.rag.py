"""ttft_p95_ms.rag: see ``servebench.readers``."""
from servebench.readers import ttft_p95_ms as read  # noqa: F401
