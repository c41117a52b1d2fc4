"""step_wait_ms.backlog: see ``servebench.spans.step_wait_ms``."""
from servebench.spans import step_wait_ms as read  # noqa: F401
