"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository root; those marked `cuda` run only on a card."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))
