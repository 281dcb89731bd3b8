"""The benchmark's own tests: ``python -m pytest cellbench/tests`` from the
root of the checkout (the card's tests are marked ``gpu`` and skip where
there is none)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
