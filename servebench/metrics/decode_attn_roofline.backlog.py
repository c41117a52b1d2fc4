"""decode_attn_roofline.backlog: see ``servebench.readers.decode_attn_roofline``."""
from servebench.readers import decode_attn_roofline as read  # noqa: F401
