"""prefill_ms_per_ktok.rag: see ``servebench.readers.prefill_ms_per_ktok``."""
from servebench.readers import prefill_ms_per_ktok as read  # noqa: F401
