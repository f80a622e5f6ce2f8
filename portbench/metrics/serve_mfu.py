"""serve_mfu: the forward model FLOPs of the window's real tokens
(prompts without pads, decode steps, the LM head once a sequence and a
step) over the traced window's seconds at 165 TFLOP/s, in %."""
from portbench.harness.readers import mfu as read  # noqa: F401
