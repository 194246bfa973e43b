"""The whole call's share of the card's bf16 peak while calls run
(`_readers.call_mfu`), in the sweep's cells."""
from portbench.metrics._readers import call_mfu as read  # noqa: F401

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "Model step: sample.py over models/condunet.py and models/mega.py"
MOVES = "members_per_s.sweep"
