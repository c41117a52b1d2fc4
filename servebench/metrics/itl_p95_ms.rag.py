"""itl_p95_ms.rag: see ``servebench.readers``."""
from servebench.readers import itl_p95_ms as read  # noqa: F401
