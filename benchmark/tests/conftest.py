"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of a checkout. Tests marked ``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
