"""The benchmark's own tests: run from the checkout's root with

    python -m pytest portbench/tests -q

The ones marked ``cuda`` need a card and skip without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
