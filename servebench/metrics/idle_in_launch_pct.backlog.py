"""idle_in_launch_pct.backlog: see ``servebench.spans.idle_in_launch_pct``."""
from servebench.spans import idle_in_launch_pct as read  # noqa: F401
