"""Device mesh helpers.

The reference's only runtime is rayon threads in one address space
(SURVEY.md §2, Cargo.toml:15). The device replacement is a 1-D
``jax.sharding.Mesh`` over devices; XLA lowers the collectives (NCCL over
NVLink on GPUs). The cards are joined all to all, so the mesh shape follows
the algorithm only.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "shard"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (AXIS,))


def shard_leading(mesh: Mesh, x):
    """Place an [S, ...] stacked array with axis 0 split across the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(AXIS)))


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))
