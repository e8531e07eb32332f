"""The benchmark's own tests (run from the repository's root:
``python -m pytest benchmark/tests -q``). Tests that need the card carry
the ``chip`` marker and skip on a machine without one, deciding inside
the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")
