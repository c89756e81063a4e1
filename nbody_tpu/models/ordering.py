"""Spatial (Morton / Z-order) body reordering.

The reference never reorders bodies (body index = thread index forever).
Spatial ordering makes index-adjacent bodies space-adjacent, so an i-block
of the tiled force sweep is spatially compact — the prerequisite for any
future range-culling or per-block centering.  Reordering is a pure permutation
of body identity — trajectories are unchanged modulo relabeling (gravity is
permutation-equivariant), verified in tests.

Codes are 30-bit Morton (10 bits/axis) computed on device with vectorized
bit-spreading; sorting uses XLA's argsort.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .state import SimState


def _spread_bits_10(x: jax.Array) -> jax.Array:
    """Spread the low 10 bits of x so there are two zero bits between each
    (uint32 in/out)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(pos: jax.Array, lower: float, upper: float,
                 bits: int = 10) -> jax.Array:
    """30-bit Morton codes for (N,3) positions within [lower, upper]^3.
    Out-of-box positions clamp to the boundary cells."""
    if bits != 10:
        raise NotImplementedError("only 10 bits/axis supported")
    scale = (2 ** bits - 1) / (upper - lower)
    q = jnp.clip((pos - lower) * scale, 0, 2 ** bits - 1).astype(jnp.uint32)
    sx = _spread_bits_10(q[:, 0])
    sy = _spread_bits_10(q[:, 1])
    sz = _spread_bits_10(q[:, 2])
    return sx | (sy << 1) | (sz << 2)


def morton_permutation(pos: jax.Array, lower: float, upper: float
                       ) -> jax.Array:
    """Permutation that sorts bodies in Z-order."""
    return jnp.argsort(morton_codes(pos, lower, upper))


def apply_permutation(state: SimState, perm: jax.Array) -> SimState:
    return SimState(pos=state.pos[perm], vel=state.vel[perm],
                    acc=state.acc[perm], mass=state.mass[perm])


def morton_sort_state(state: SimState, lower: float, upper: float
                      ) -> Tuple[SimState, jax.Array]:
    """Z-order-sort a state. Returns (sorted_state, perm) where
    ``sorted.pos[i] == pos[perm[i]]`` (perm maps new index -> old index)."""
    perm = morton_permutation(state.pos, lower, upper)
    return apply_permutation(state, perm), perm
