"""The device's idle share of the window, read as ``device_idle_pct.py`` reads
it, in the replan cells, whose rate is ``replan_solves_per_s``. Moves
``replan_solves_per_s``."""

from eebench.harness import layer_reader

UNIT, MOVES, LAYER = "%", "replan_solves_per_s", "device"
read = layer_reader("device_idle_pct").read
