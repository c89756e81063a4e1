"""Simulation state pytree.

The reference stores bodies as AoS ``float4 {x,y,z,w=mass}`` plus float4/float3
velocity and acceleration arrays in GPU global memory (``kernel.cu:80``,
``main.cpp:250-252``).  Here the state is ``(N, 3)`` coordinate arrays plus a
separate ``(N,)`` mass vector, so mass can be broadcast separately from
positions; the tiled force kernel repacks the four fields as a ``(4, N)``
SoA array (``ops/forces_pallas.py``).

Padding: the reference guards out-of-range threads with ``tid >= N`` checks
(``kernel.cu:90-92``).  Here N is padded up to a tile multiple with *ghost
bodies* of mass 0 at the origin: a zero-mass body contributes exactly zero
force (factor = m_j * inv = 0, ``kernel.cu:23``), so no masking is needed in
the hot loop — the same property that makes the reference's missing i!=j guard
safe under softening (r=0 => zero contribution, ``kernel.cu:17-27``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SimState(NamedTuple):
    """State of an N-body system. All leaves share a leading dimension N
    (possibly padded; ``n_real`` tracks the live count)."""

    pos: jax.Array   # (N, 3) positions
    vel: jax.Array   # (N, 3) velocities
    acc: jax.Array   # (N, 3) accelerations from the last step
    mass: jax.Array  # (N,)  masses (0 for padding ghosts)

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_state(state: SimState, multiple: int) -> SimState:
    """Pad state with zero-mass ghost bodies so N is a tile multiple."""
    return pad_state_to(state, round_up(state.n, multiple))


def pad_state_to(state: SimState, n_pad: int) -> SimState:
    """Pad state with zero-mass ghost bodies up to exactly n_pad bodies."""
    n = state.n
    if n_pad == n:
        return state
    if n_pad < n:
        raise ValueError(f"cannot pad {n} bodies down to {n_pad}")
    extra = n_pad - n
    pad3 = jnp.zeros((extra, 3), dtype=state.pos.dtype)
    return SimState(
        pos=jnp.concatenate([state.pos, pad3]),
        vel=jnp.concatenate([state.vel, pad3]),
        acc=jnp.concatenate([state.acc, pad3]),
        mass=jnp.concatenate(
            [state.mass, jnp.zeros((extra,), dtype=state.mass.dtype)]),
    )


def unpad_state(state: SimState, n_real: int) -> SimState:
    if state.n == n_real:
        return state
    return SimState(
        pos=state.pos[:n_real],
        vel=state.vel[:n_real],
        acc=state.acc[:n_real],
        mass=state.mass[:n_real],
    )


def state_to_numpy(state: SimState) -> "dict[str, np.ndarray]":
    return {
        "pos": np.asarray(state.pos),
        "vel": np.asarray(state.vel),
        "acc": np.asarray(state.acc),
        "mass": np.asarray(state.mass),
    }


def state_from_numpy(arrays, dtype=jnp.float32) -> SimState:
    return SimState(
        pos=jnp.asarray(arrays["pos"], dtype=dtype),
        vel=jnp.asarray(arrays["vel"], dtype=dtype),
        acc=jnp.asarray(arrays["acc"], dtype=dtype),
        mass=jnp.asarray(arrays["mass"], dtype=dtype),
    )
