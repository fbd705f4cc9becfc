"""Control plane: median wait from a request's due arrival to its
first dispatch, in the interactive image cell."""
from perfbench.readers import queue_wait_p50_s as read  # noqa: F401
