"""The fused core stack kernel's share of its roofline
(`_readers.stack_roofline`), in the sweep's cells."""
from portbench.metrics._readers import stack_roofline as read  # noqa: F401

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Kernels: csrc/core_onepass.cu core_stack_wgmma_kernel"
MOVES = "members_per_s.sweep"
