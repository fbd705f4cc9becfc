"""Card: share of the time with a request in the system in which no
operation ran on the card, in %, in the video cell."""
from perfbench.readers import idle_share as read  # noqa: F401
