"""Card: share of the time with a request in the system in which no
operation ran on the card, in %, in the image backlog."""
from perfbench.readers import idle_share as read  # noqa: F401
