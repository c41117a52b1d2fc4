"""moe_prefill_drop_pct.backlog: see ``servebench.spans.moe_prefill_drop_pct``."""
from servebench.spans import moe_prefill_drop_pct as read  # noqa: F401
