"""Model step (cuBLAS): product FLOPs at the fp32-accurate peak over
the matrix-product kernels' device time, in %, in the video cell."""
from perfbench.readers import gemm_roofline as read  # noqa: F401
