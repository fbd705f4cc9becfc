"""Executor and pipeline: median host time from the end of a
pipeline call to the rank's next call, work waiting, in the
image backlog."""
from perfbench.readers import dispatch_gap_ms as read  # noqa: F401
