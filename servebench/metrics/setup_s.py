"""setup_s: see ``servebench.readers``."""
from servebench.readers import setup_s as read  # noqa: F401
