"""ssd_chunk_roofline.serve: the SSD intra-chunk calls' least time
(their products at the dtype's peak, or bytes at HBM's) over the device
time launched inside them, in prefill, in %."""
from portbench.harness.kernel_work import ssd_chunk_work
from portbench.harness.readers import kernel_roofline

SPANS = [("ssd_chunk", "repro_torch.models.ssm", "ssd_chunk", ssd_chunk_work)]


def read(record):
    return kernel_roofline(record, "ssd_chunk")
