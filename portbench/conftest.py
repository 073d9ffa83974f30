"""The CPU size of each configuration added after ``tests/small.py``'s
table, registered in that table (``small.SMALL``) before any test runs,
so that every test parametrised over the cells runs these too."""
from portbench.tests import small

# yeast-worm-r4096 is yeast-worm with R cut to two R blocks
small.SMALL.setdefault("yeast-worm-r4096", dict(small.SMALL["yeast-worm"], n_r=256))
