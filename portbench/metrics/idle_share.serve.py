"""idle_share.serve: the share of the traced serving window with no
device activity (kernel, copy or set), in %."""
from portbench.harness.readers import idle_share as read  # noqa: F401
