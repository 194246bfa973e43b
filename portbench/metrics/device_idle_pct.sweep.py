"""The share of the traced stretch with no kernel on the card
(`_readers.idle_pct`), in the sweep's cells."""
from portbench.metrics._readers import idle_pct as read  # noqa: F401

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device"
MOVES = "members_per_s.sweep"
