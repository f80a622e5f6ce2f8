"""idle_share.train: the share of the traced training window with no
device activity (kernel, copy or set), in %."""
from portbench.harness.readers import idle_share as read  # noqa: F401
