"""Device mesh construction.

The reference's only parallelism is shared-memory rayon loops
(index.rs:77,443); the device design replaces it with a
jax.sharding Mesh. Axes:

- "dp": data parallel over read batches (the rayon par_iter analog);
- "ix": optional index sharding — the minimizer table is split into
  contiguous sorted-key ranges, one per device, with all-to-all anchor
  exchange (SURVEY.md section 2 parallelism table).

A single mesh of shape (dp, ix) covers both: replicated-index mapping
uses ix=1.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(dp: int | None = None, ix: int = 1, devices=None) -> Mesh:
    """Mesh of shape (dp, ix). dp defaults to n_devices // ix."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // ix
    if dp * ix > n:
        raise ValueError(f"mesh {dp}x{ix} needs {dp*ix} devices, have {n}")
    arr = np.array(devices[: dp * ix]).reshape(dp, ix)
    return Mesh(arr, axis_names=("dp", "ix"))
