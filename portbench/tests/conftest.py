"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from
the root of the repository (``-m cuda`` on the card for the ones that need
it).  The repository's tier-1 run does not collect them."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
