"""The share of the traced window's wall time with no kernel, copy or set
running on the card, in percent (``shares.idle_share``)."""
from amc_bench.shares import idle_share as read  # noqa: F401
