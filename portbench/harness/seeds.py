"""Seeds derived from a run's ``--seed``: one stream per purpose, the
same for the same seed and key, for any whole number."""
from __future__ import annotations

import numpy as np

# purposes
WEIGHTS = 1
TRAFFIC = 2
SAMPLE = 3


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` and numpy."""
    entropy = [int(seed) % (1 << 64)] + [int(k) for k in keys]
    lo, hi = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(hi) << 31 | int(lo)) & ((1 << 63) - 1)


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *keys))
