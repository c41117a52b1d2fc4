"""decode_step_ms.rag: see ``servebench.readers.decode_step_ms``."""
from servebench.readers import decode_step_ms as read  # noqa: F401
