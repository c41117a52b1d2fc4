"""step_wait_ms.rag: see ``servebench.spans.step_wait_ms``."""
from servebench.spans import step_wait_ms as read  # noqa: F401
