"""live_slot_pct.rag: see ``servebench.spans.live_slot_pct``."""
from servebench.spans import live_slot_pct as read  # noqa: F401
