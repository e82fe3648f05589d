"""The benchmark's own tests (not collected by `pytest tests/`). Run from
the repository root: python -m pytest benchmark/tests -q"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
