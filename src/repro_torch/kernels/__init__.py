"""Hand-written Hopper kernels of the port and their plain twins.

Importing this package builds nothing: each CUDA source is compiled at
its first launch (``_build``)."""
from repro_torch.kernels.protocol_sweep import (LAUNCHES,  # noqa: F401
                                                coverage_multi, pack_rows,
                                                phase_step, popcount_rows,
                                                reset_launches, unpack_rows)
