"""The CUDA runtime calls a tick, read as ``host_calls_per_tick.py`` reads it,
in the replan cells, whose rate is ``replan_solves_per_s``. Moves
``replan_solves_per_s``."""

from eebench.harness import layer_reader

UNIT, MOVES, LAYER = "calls/tick", "replan_solves_per_s", "engine API and graphs"
read = layer_reader("host_calls_per_tick").read
