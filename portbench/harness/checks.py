"""The numbers that decide ``correct``, and the judgement against the
cell's limits (``limits/<workload>.json``).

Training (each a relative gap, the program's reading against the
reference's):

* ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the checked steps;
* ``grad_gap``: the worst leaf's |norm - reference norm| of the first
  gradient as the optimiser takes it (clipped), over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same for the change of the parameters over the
  checked steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone under Adam; they are left out of
``change_gap`` (none is, in the dense configuration).

Serving (over the sampled requests' served tokens, the reference
teacher-forced on the program's tokens):

* ``token_gap``: the widest gap by which a served token's logit lies
  below the reference's largest at its position;
* ``logit_err``: the largest |program logit - reference logit| there.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, Optional

EXCLUDE_BELOW = 1e-3


def loss_gap(losses, ref_losses) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))


def leaf_gaps(norms: Dict[str, float], ref_norms: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's |norm - reference norm| over the larger of its
    reference norm and the median leaf's."""
    keys = [k for k in ref_norms if keep is None or k in keep]
    floor = median(ref_norms[k] for k in keys)
    return {k: abs(norms[k] - ref_norms[k]) / max(ref_norms[k], floor)
            for k in keys}


def leaf_gap(norms, ref_norms, keep=None) -> float:
    return max(leaf_gaps(norms, ref_norms, keep).values())


def moving_leaves(ref_grad_norms: Dict[str, float]):
    floor = median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items()
            if v >= EXCLUDE_BELOW * floor}


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    """``got`` and ``ref`` hold ``losses`` (list), ``grad_norms`` and
    ``change_norms`` (leaf path -> norm)."""
    keep = moving_leaves(ref["grad_norms"])
    return {"loss_gap": loss_gap(got["losses"], ref["losses"]),
            "grad_gap": leaf_gap(got["grad_norms"], ref["grad_norms"]),
            "change_gap": leaf_gap(got["change_norms"], ref["change_norms"],
                                   keep)}


def serve_numbers(logits, ref_logits, tokens) -> Dict[str, float]:
    """``logits`` and ``ref_logits`` (n, V) at the served positions (the
    program's may be None: its logits were not read), ``tokens`` (n,)
    the served tokens."""
    best = ref_logits.max(dim=-1).values
    served = ref_logits.gather(1, tokens[:, None].long())[:, 0]
    out = {"token_gap": float((best - served).max())}
    if logits is not None:
        out["logit_err"] = float((logits - ref_logits).abs().max())
    return out


def judge(numbers: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, checks): every limited number present, finite and at or
    under its limit; ``checks`` maps each name to its value and limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
