"""Make ``pytest tests/`` work without PYTHONPATH=src (and never touch
jax device state here — the dry-run owns XLA_FLAGS, per DESIGN.md)."""
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, os.path.abspath(SRC))
# repo root too, so the reprolint test modules can import ``tools.reprolint``
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (skips without one; run on the card with "
        "`pytest -m cuda tests/test_torch_cuda.py`)",
    )
