"""The step-aligned window (from a denoise step's end to the first
step end at least the run's seconds later) over the steps in it."""
from perfbench.readers import step_s as read  # noqa: F401
