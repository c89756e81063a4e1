"""Pure-XLA all-pairs force backends.

These are the XLA analog of the reference's *interaction-parallel* ("NxN
reduction") kernel family (``kernel.cu:163-469``): the O(N^2) interaction set
is materialized as a matrix and reduced along j, instead of each body serially
sweeping tiles.  Two variants, mirroring the reference's two shapes:

- ``forces_nxn``: the full NxN broadcast + sum — the direct analog of
  ``kernel_reduction`` + ``inter_block_reduction`` (one "thread" per pair,
  reduce along j).  O(N^2) memory; its role is small-N cross-checking, exactly
  like the reference's reduction family at N=8192.
- ``forces_chunked``: a ``lax.scan`` over i-chunks, each chunk an
  (C x N) interaction block summed in the direct form — bounded memory,
  usable at any N.  This is also
  the oracle-independent second device implementation the tiled kernel is
  cross-checked against (SURVEY.md section 4).

Force math matches ``bodyInteractions`` (``kernel.cu:9-29``) exactly:
``d2 = |r_ij|^2 + eps2; a_i += m_j * r_ij * rsqrt(d2^3)`` with no i != j guard
(the self-pair contributes exactly zero under softening) and no G constant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pair_factor(d2):
    """m-free part: rsqrt(d2^3), the analog of ``1/sqrtf(distSqrt^3)``
    (kernel.cu:20)."""
    return jax.lax.rsqrt(d2 * d2 * d2)


def rect_forces(pos_i: jax.Array, pos_j: jax.Array, mass_j: jax.Array,
                eps2: float, chunk: int = 1024) -> jax.Array:
    """Forces exerted by body set j on body set i (the 'rectangular' block of
    the interaction matrix).  This is the building block of the multi-device
    ring sweep (parallel/ring.py): each device holds an i-shard and sweeps
    rotating j-tiles — the cross-device lift of the reference's intra-GPU
    tile sweep (kernel.cu:99-114).

    Direct-form accumulation (self-pairs vanish via r=0), chunked over i.
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3).
    """
    ni = pos_i.shape[0]
    chunk = min(chunk, ni)
    n_pad = -(-ni // chunk) * chunk
    pad = n_pad - ni
    pos_i_p = jnp.pad(pos_i, ((0, pad), (0, 0)))

    def body(_, pos_c):
        r = pos_j[None, :, :] - pos_c[:, None, :]   # (C, Nj, 3)
        d2 = jnp.sum(r * r, axis=-1) + eps2
        f = mass_j[None, :] * _pair_factor(d2)      # (C, Nj)
        return None, jnp.sum(f[:, :, None] * r, axis=1)

    _, acc = jax.lax.scan(body, None, pos_i_p.reshape(-1, chunk, 3))
    return acc.reshape(n_pad, 3)[:ni].astype(pos_i.dtype)


def forces_nxn(pos: jax.Array, mass: jax.Array, eps2: float) -> jax.Array:
    """Full NxN interaction matrix, reduced along j. (N,3),(N,) -> (N,3)."""
    r = pos[None, :, :] - pos[:, None, :]          # (N, N, 3): r_ij = x_j - x_i
    d2 = jnp.sum(r * r, axis=-1) + eps2            # (N, N)
    f = mass[None, :] * _pair_factor(d2)           # (N, N)
    return jnp.sum(f[:, :, None] * r, axis=1)      # (N, 3)


def forces_chunked(pos: jax.Array, mass: jax.Array, eps2: float,
                   chunk: int = 1024) -> jax.Array:
    """Scan over i-chunks; each chunk does a (C, N) interaction block,
    summed in the direct form ``a_i = sum_j f_ij r_ij`` (the self-pair
    vanishes through r_ii = 0, kernel.cu:17-27).

    The direct form keeps the exact float32 class.  (A matmul
    decomposition ``a_i = f @ pos - x_i * rowsum(f)`` would cancel two
    terms of magnitude |x_i| * rowsum(f): a close pair at domain scale
    1e5 puts that cancellation error past the 1% gate.)
    (N,3),(N,) -> (N,3)."""
    return rect_forces(pos, pos, mass, eps2, chunk=chunk)
