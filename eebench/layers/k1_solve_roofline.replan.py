"""K1's solve and safety share of their roofline, read as
``k1_solve_roofline.py`` reads it, in the replan cells, whose rate is
``replan_solves_per_s``. Moves ``replan_solves_per_s``."""

from eebench.harness import layer_reader

UNIT, MOVES, LAYER = "%", "replan_solves_per_s", "K1 solve and safety"
read = layer_reader("k1_solve_roofline").read
