"""Force-backend dispatch, and the one rule that decides which force path
runs on this device.

The analog of the reference's kernel-family selection (``REDUCTION``/``FADL``
compile-time flags + stdin kernel-type prompt, ``constants.h:4-7`` /
``main.cpp:185-206``), made a runtime choice behind one function.
"""

from __future__ import annotations

import jax

from ..config import SimConfig
from ..utils.device import kernel_available
from .forces_xla import forces_chunked, forces_nxn

# Full NxN materialization is O(N^2); cap where its ~(N^2 * 4B) buffers stay
# comfortably in device memory and compile time stays sane.
_NXN_MAX_N = 16384

# XLA's broadcast+reduce form is the small-N path off the GPU kernel.
_NXN_AUTO_MAX_N = 4096

# Smallest N at which the tiled kernel beats both XLA paths end to end on
# an H100: it loses at N <= 2048, where too few programs fill the card, and
# wins from 4096 up (PERF.md "Kernel against XLA").
PALLAS_MIN_N = 4096


def resolve_impl(cfg: SimConfig, sharded: bool = False) -> str:
    """Resolve impl='auto' to a concrete force path for this device.

    On the GPU, float32 runs of at least ``PALLAS_MIN_N`` bodies take the
    tiled kernel.  Everything else takes XLA: the broadcast+reduce form at
    small N on one device, the chunked form otherwise (a mesh's local sweep
    is rectangular, which only the chunked form and the kernel serve)."""
    if cfg.impl != "auto":
        return cfg.impl
    n = cfg.n_bodies
    if (kernel_available() and cfg.dtype == "float32"
            and n >= PALLAS_MIN_N):
        return "pallas"
    if n <= _NXN_AUTO_MAX_N and not sharded:
        return "xla_nxn"
    return "xla"


def compute_forces(pos: jax.Array, mass: jax.Array, cfg: SimConfig,
                   impl: "str | None" = None) -> jax.Array:
    """Softened all-pairs gravitational acceleration (N,3)."""
    impl = impl or resolve_impl(cfg)
    if impl == "xla_nxn":
        if pos.shape[0] > _NXN_MAX_N:
            raise ValueError(
                f"impl='xla_nxn' materializes O(N^2); N={pos.shape[0]} > "
                f"{_NXN_MAX_N}. Use 'xla' or 'pallas'.")
        return forces_nxn(pos, mass, cfg.eps2)
    if impl == "xla":
        return forces_chunked(pos, mass, cfg.eps2, chunk=cfg.chunk)
    if impl == "pallas":
        from . import forces_pallas
        return forces_pallas.forces_pallas(
            pos, mass, cfg.eps2, block_i=cfg.block_i, block_j=cfg.block_j)
    raise ValueError(f"unknown force impl {impl!r}")
