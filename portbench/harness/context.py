"""What a driver is handed: the cell, the device, the seed and the run's
switches, and the helpers every driver shares."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Optional

from . import seeds, weights


@dataclasses.dataclass
class Ctx:
    torch: Any
    device: Any
    cell: Any                      # bench.Cell
    seed: int
    # a fault planted under the timed path (tests and calibration only):
    # "unchanged" (a step returns the state it was given), "half" (half
    # of the batch left out, the mean over the rest), "token" (each
    # request's last served token altered where it is produced)
    fault: Optional[str] = None

    @property
    def conf(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> float:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def weights(self):
        """The cell's weights, made on the device from the seed."""
        return weights.make(self.torch, self.cell.reference().layout(
            self.conf), seeds.derive(self.seed, seeds.WEIGHTS), self.device)

    def free(self):
        import gc
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def log(msg: str):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def path_name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def leaves(tree, layout) -> dict:
    """{path name: tensor} of ``tree`` in the layout's order."""
    return {path_name(p): weights.tree_get(tree, p) for p, *_ in layout}


def check_layout(cfg, layout):
    """Raise unless the program's parameter tree for ``cfg`` has the
    reference's layout: the same leaves, the same shapes."""
    from repro_torch.models.model import param_specs
    specs = param_specs(cfg)
    want = {path_name(p): tuple(s) for p, s, *_ in layout}
    have = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                walk(v, prefix + (i,))
        else:
            have[path_name(prefix)] = tuple(node.shape)
    walk(specs, ())
    if have != want:
        raise ValueError(f"the program's parameters {have} differ from the "
                         f"reference's layout {want}")
