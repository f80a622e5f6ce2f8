"""train_mfu: the train step's model FLOPs (forward and backward,
no remat rerun) over the traced window's seconds at 165 TFLOP/s, in %."""
from portbench.harness.readers import mfu as read  # noqa: F401
