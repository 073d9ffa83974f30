"""The benchmark's CPU tests: ``python -m pytest portbench/tests`` from the
checkout's root.  The program under test lives in ``src``."""
import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
