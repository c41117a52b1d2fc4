"""moe_ms_per_ktok.backlog: see ``servebench.readers.moe_ms_per_ktok``."""
from servebench.readers import moe_ms_per_ktok as read  # noqa: F401
