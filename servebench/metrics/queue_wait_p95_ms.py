"""queue_wait_p95_ms: see ``servebench.readers``."""
from servebench.readers import queue_wait_p95_ms as read  # noqa: F401
