"""Fused-core stack launches a call (`_readers.launches_per_call`), in the
sweep's cells."""
from portbench.metrics._readers import launches_per_call as read  # noqa: F401

UNIT = "launches"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "Fused-core plan: models/mega.py mega_plan, mega_route"
MOVES = "members_per_s.sweep"
