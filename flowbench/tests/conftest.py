"""The benchmark's CPU tests: run from the repository root, ``python -m pytest flowbench/tests``;
``-m cuda`` on a card runs the control at a small size."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
