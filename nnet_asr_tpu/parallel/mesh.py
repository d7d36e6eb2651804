"""Device-mesh construction.

Replaces the reference's device placement (CuDevice free-memory GPU
auto-select, cudevice.cc:22-101, and SGE job-level clustering) with a JAX
``Mesh`` over (data, model) axes: data parallelism rides the batch axis
(the analog of Platform's N trainer threads, Platform.h:143-391),
model parallelism shards the senone output dimension (the analog of the
reference's row-striped update / BlockSoftmax column structure).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh. ``data=None`` uses all remaining devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    dev = np.asarray(devices[:data * model]).reshape(data, model)
    return Mesh(dev, ("data", "model"))
