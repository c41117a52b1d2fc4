"""flash_roofline.rag: see ``servebench.readers.flash_roofline``."""
from servebench.readers import flash_roofline as read  # noqa: F401
