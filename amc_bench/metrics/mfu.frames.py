"""Model operations of every frame classified in the traced window, over
the window's seconds times the configuration's data-sheet peak, in
percent (``shares.model_flops_share``)."""
from amc_bench.shares import model_flops_share as read  # noqa: F401
