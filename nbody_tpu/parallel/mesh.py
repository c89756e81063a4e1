"""Device-mesh construction.

The reference is single-GPU, single-process (``cudaGetDeviceProperties(&prop,
0)`` hard-codes device 0 everywhere — SURVEY.md section 2.3); its only
"distribution" is intra-GPU.  The rebuild's distributed backend is XLA
collectives, expressed through ``jax.sharding.Mesh`` + ``shard_map``: compiled
``lax.ppermute`` / ``all_gather`` / ``psum``, which XLA hands to NCCL on the
GPU (SURVEY.md section 5, 'Distributed communication backend').
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shard"


def make_mesh(n_devices: Optional[int] = None, axis: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over the local devices.  The cards of one host are joined
    all to all, so the mesh follows the algorithm alone."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def body_sharding(mesh: Mesh, axis: str = SHARD_AXIS) -> NamedSharding:
    """Bodies sharded along the leading axis; trailing dims replicated."""
    return NamedSharding(mesh, P(axis))


def shard_state(state, mesh: Mesh, axis: str = SHARD_AXIS):
    """Place a SimState with bodies sharded across the mesh axis."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)
