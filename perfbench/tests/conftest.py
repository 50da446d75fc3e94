"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the checkout (CPU); ``python -m pytest -m cuda perfbench/tests``
on a machine with a card runs the ones that need it."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
