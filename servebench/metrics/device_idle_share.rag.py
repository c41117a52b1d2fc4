"""device_idle_share.rag: see ``servebench.readers.device_idle_share``."""
from servebench.readers import device_idle_share as read  # noqa: F401
