"""The SDXL cell's small size (`tiny_xl.py`) registered beside the other
cells' in `tiny.OVERRIDES`, so the tests that run every cell of
BENCHMARK.json at a small size find it."""
from portbench.tests import tiny, tiny_xl

for _cell, _overrides in tiny_xl.OVERRIDES.items():
    tiny.OVERRIDES.setdefault(_cell, _overrides)
