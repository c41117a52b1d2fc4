"""step_launch_ms.backlog: see ``servebench.spans.step_launch_ms``."""
from servebench.spans import step_launch_ms as read  # noqa: F401
