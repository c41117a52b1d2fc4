"""insert_cache_ms.backlog: see ``servebench.spans.insert_cache_ms``."""
from servebench.spans import insert_cache_ms as read  # noqa: F401
