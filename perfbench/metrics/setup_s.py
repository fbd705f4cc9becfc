"""Set-up time: process start to the window's opening (the kernel
library's load or build, the engine, the weights, the warm-up
serves; a step-aligned window also its first request's encode and
first step)."""
def read(rec):
    return rec.setup_s
