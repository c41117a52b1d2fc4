"""decode_attn_roofline.rag: see ``servebench.readers.decode_attn_roofline``."""
from servebench.readers import decode_attn_roofline as read  # noqa: F401
