"""Device-mesh helpers.

The reference has no communication backend at all — multi-GPU is a host
``cudaSetDevice`` loop with host-staged ordered gathers
(`gpuhd/multigpu_demo.cc:176-314`).  Here it is one global
``jax.sharding.Mesh`` over all devices (and hosts, via ``jax.distributed``):
the code table broadcasts as a replicated array, the block axis shards over
``data``, and the ordered gather is simply the output sharding.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["data_mesh", "P", "NamedSharding", "Mesh"]

DATA_AXIS = "data"


def data_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over (up to) n_devices along the ``data`` axis."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (DATA_AXIS,))
