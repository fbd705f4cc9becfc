"""Images completed in the window over the time from its opening to
the last of those completions."""
from perfbench.readers import images_per_s as read  # noqa: F401
