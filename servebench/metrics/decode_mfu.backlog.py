"""decode_mfu.backlog: see ``servebench.readers.decode_mfu``."""
from servebench.readers import decode_mfu as read  # noqa: F401
