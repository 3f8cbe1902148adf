"""The tick glue's device time a tick, read as ``glue_ms_per_tick.py`` reads
it, in the replan cells, whose rate is ``replan_solves_per_s``. Moves
``replan_solves_per_s``."""

from eebench.harness import layer_reader

UNIT, MOVES, LAYER = "ms", "replan_solves_per_s", "tick glue G"
read = layer_reader("glue_ms_per_tick").read
