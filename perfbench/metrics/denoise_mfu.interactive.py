"""Model step: denoise FLOPs over the summed denoise call spans at
the H100's fp32-accurate peak (3xTF32), in %, in the interactive image cell."""
from perfbench.readers import denoise_mfu as read  # noqa: F401
