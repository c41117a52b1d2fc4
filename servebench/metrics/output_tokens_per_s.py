"""output_tokens_per_s: see ``servebench.readers``."""
from servebench.readers import output_tokens_per_s as read  # noqa: F401
