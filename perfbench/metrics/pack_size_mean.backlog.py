"""Control plane: mean requests a denoise dispatch carries (step
packing) in the window of the image backlog."""
from perfbench.readers import pack_size_mean as read  # noqa: F401
