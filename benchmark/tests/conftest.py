"""The benchmark's own tests: on the CPU at tiny sizes, and the control's
runs on the card (marker ``cuda``), which skip without one.

    python -m pytest benchmark/tests -q
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for path in (BENCH, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA H100; skips elsewhere")
