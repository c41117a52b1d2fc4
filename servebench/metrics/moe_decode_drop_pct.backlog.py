"""moe_decode_drop_pct.backlog: see ``servebench.spans.moe_decode_drop_pct``."""
from servebench.spans import moe_decode_drop_pct as read  # noqa: F401
