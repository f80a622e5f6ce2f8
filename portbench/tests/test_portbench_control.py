"""The control on the card: the plain reference computed in TF32 (the
precision below the configurations' float32 with TF32 off) put in the
program's place fails the cell's limits, while the program passes them.

At the cells' widths with fewer layers and shorter sequences, so that a
test run holds it; the benchmark's own runs never run the control
(``run.py --calibrate`` reads it at the cells' sizes).  Needs a card:
skips without one."""
from __future__ import annotations

import pytest
import torch

from portbench.harness.checks import judge
from portbench.harness.context import Ctx
from portbench.tests.tiny import full_cell

SMALL = {
    "internlm2-train-4k": ({"num_hidden_layers": 4}, {"seq": 1024}),
    "mamba2-serve-doc2k": ({"n_layer": 8},
                           {"prompt_min": 256, "prompt_max": 512,
                            "check_requests": 8, "batch": 8}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("seed", [(1 << 31) + 101, (1 << 31) + 202,
                                  (1 << 31) + 303])
def test_control_fails_and_program_passes(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.run import start
    torch_, dev = start()
    cell = full_cell(workload)
    conf, traffic = SMALL[workload]
    cell.config = {**cell.config, **conf}
    cell.traffic = {**cell.traffic, **traffic}
    ctx = Ctx(torch=torch_, device=dev, cell=cell, seed=seed)
    driver = cell.driver()
    state = driver.setup(ctx)
    if cell.traffic["driver"] == "serve":
        driver.window(ctx, state, waves=1)
    got = driver.calibrate(ctx, state, control=True)
    ok, checks = judge(got["program"], cell.limits)
    assert ok, checks
    ok, checks = judge(got["control"], cell.limits)
    assert not ok, checks
