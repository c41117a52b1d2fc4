"""What ``run.py``, ``sweep.py`` and ``calibrate.py`` share: the import
path (the checkout's root and its ``src``, not the script's folder) and the
card check."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def set_path() -> None:
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if not p or Path(p).resolve() != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def card_or_exit(chips: int) -> None:
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < chips:
        print(f"servebench: needs {chips} CUDA card(s); {n} found", file=sys.stderr)
        raise SystemExit(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
