"""Hand-written Hopper kernels of the port and their plain twins.

Importing this package builds nothing: each CUDA source is compiled at
its first launch (``_build``)."""
from repro_torch.kernels.page_diff import diff_apply, diff_encode  # noqa: F401
from repro_torch.kernels.protocol_sweep import (  # noqa: F401
    LAUNCHES, coverage_multi, kth_set_index, pack_rows, phase_step,
    popcount_rows, read_take_run, reset_launches, take_and_cut,
    take_first_k, take_run, unpack_rows)
