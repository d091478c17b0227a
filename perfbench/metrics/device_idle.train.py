"""Share of the traced training window in which no kernel, copy or fill
ran on the card."""
from perfbench.metrics_common import idle_share as read  # noqa: F401
