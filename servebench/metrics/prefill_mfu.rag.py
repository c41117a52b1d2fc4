"""prefill_mfu.rag: see ``servebench.readers.prefill_mfu``."""
from servebench.readers import prefill_mfu as read  # noqa: F401
