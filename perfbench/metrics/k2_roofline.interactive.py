"""Kernels: attention's least time at the fp32-accurate peak or HBM
bandwidth over the attention kernels' device time, in %, in the
interactive image cell."""
from perfbench.readers import k2_roofline as read  # noqa: F401
