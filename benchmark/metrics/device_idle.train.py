"""``device_idle.train``: the share of the traced window in which no
activity ran on the card."""

from benchmark.trace import idle_percent as read  # noqa: F401
