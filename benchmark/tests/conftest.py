"""The benchmark's own tests: the harness end to end on the CPU at tiny
sizes through the program's plain paths, and (marked ``gpu``) the controls
on a card at the cells' own sizes."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
