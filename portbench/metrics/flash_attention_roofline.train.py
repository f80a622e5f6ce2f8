"""flash_attention_roofline.train: the attention calls' least time
(causal FLOPs at the dtype's peak, or bytes at HBM's) over the device time
launched inside them, in training (forward and remat rerun), in %."""
from portbench.harness.kernel_work import flash_attention_work
from portbench.harness.readers import kernel_roofline

SPANS = [("flash_attention", "repro_torch.models.layers", "flash_attention",
          flash_attention_work)]


def read(record):
    return kernel_roofline(record, "flash_attention")
