"""decode_step_ms.backlog: see ``servebench.readers.decode_step_ms``."""
from servebench.readers import decode_step_ms as read  # noqa: F401
