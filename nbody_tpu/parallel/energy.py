"""Total energy ON A MESH — bounded per-device pair-potential programs.

The reference has no conservation accounting at all (SURVEY.md §5); the
rebuild's drift gates are defined over the softened pair potential, and
``models/energy.py`` provides the single-device path (host f64, then
``total_energy_bounded``).  This module computes ``track_energy`` on a mesh
without gathering the sharded state to one device:

- state stays sharded; each device sums ``m_i m_j (|r|^2+eps2)^{-1/2}``
  of its row shard against a VISITING column shard that walks the ring
  (``lax.ppermute``), exactly the force ring's communication pattern;
- symmetry halves the sweep: rotations k and P-k cover the same
  unordered shard pairs, so only k = 0..floor(P/2) are evaluated (cross
  rotations doubled; the antipodal rotation of an even ring already
  contains both orderings across devices, so it is counted once);
- every program is bounded: each rotation's per-device sweep splits along
  the row axis into ``max_prog_pairs``-sized compile-once programs
  (dynamic row offset, at most two distinct row-chunk shapes);
- per-program partials combine in float64 on host; zero-mass ghosts are
  inert on both sides, and self-pairs are masked in place like
  ``models/energy.py::_pe_rows`` (they exist only in rotation 0, where
  local row index == local column index — no global ids needed).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.energy import MAX_HOST_ENERGY_N  # noqa: F401  (re-export:
#    Simulation routes on it; the single definition lives with energy_f64)
from ..models.state import pad_state_to, round_up
from .mesh import SHARD_AXIS


def _row_chunks(c: int, block_i: int, max_prog_pairs: float):
    """Split a device's c rows into (offset, rows) chunks of at most
    ``max_prog_pairs / c`` rows each, block_i-aligned, sizes differing by
    at most one block (so at most TWO compiled program shapes)."""
    blocks = c // block_i
    target = max(1, int(max_prog_pairs // max(c, 1)) // block_i)
    n_chunks = max(1, -(-blocks // target))
    base, extra = divmod(blocks, n_chunks)
    sizes = [(base + 1) * block_i] * extra + [base * block_i] * (
        n_chunks - extra)
    out, off = [], 0
    for s in sizes:
        out.append((off, s))
        off += s
    return out


@functools.lru_cache(maxsize=8)
def _energy_programs(mesh: Mesh, axis: str, c: int, eps2: float,
                     row_sizes: tuple):
    """Compile-once jitted shard_map programs for one (mesh, geometry)."""
    p = mesh.shape[axis]
    S = P(axis)
    R = P()
    fwd = [(i, (i + 1) % p) for i in range(p)]

    def sm(fn, in_specs, out_specs):
        return jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False))

    def ke_local(vel_l, mass_l):
        return jnp.reshape(
            0.5 * jnp.sum(mass_l * jnp.sum(vel_l * vel_l, axis=-1)), (1,))

    def rot_local(pos_v, mass_v):
        return (jax.lax.ppermute(pos_v, axis, fwd),
                jax.lax.ppermute(mass_v, axis, fwd))

    progs = {"ke": sm(ke_local, (S, S), S), "rot": sm(rot_local, (S, S),
                                                       (S, S))}
    # col must DIVIDE the shard size for the reshape below; c is only
    # guaranteed to be a multiple of the row block, so take the gcd.
    col = math.gcd(c, 2048)

    def make_pe(rows, mask_diag):
        def pe_local(pos_l, mass_l, pos_v, mass_v, off):
            pos_r = jax.lax.dynamic_slice(pos_l, (off, 0), (rows, 3))
            mass_r = jax.lax.dynamic_slice(mass_l, (off,), (rows,))
            # Self-pairs masked IN PLACE: their m_i^2 rsqrt(eps2) value
            # dwarfs physical pair terms at reference-range masses, so
            # subtracting after accumulation cancels catastrophically in
            # f32.  Per-row f32 carries, f64 host combination outside.
            i_ids = off + jax.lax.broadcasted_iota(jnp.int32, (rows, 1), 0)

            def body(carry, args):
                pos_c, mass_c, cstart = args
                r = pos_c[None, :, :] - pos_r[:, None, :]
                d2 = jnp.sum(r * r, axis=-1) + eps2
                inv = jax.lax.rsqrt(d2)
                if mask_diag:
                    j_ids = cstart + jax.lax.broadcasted_iota(
                        jnp.int32, (1, col), 1)
                    inv = jnp.where(j_ids == i_ids, 0.0, inv)
                return carry + jnp.sum(mass_c[None, :] * inv, axis=1), None

            cstarts = jnp.arange(0, pos_v.shape[0], col, dtype=jnp.int32)
            cols = (pos_v.reshape(-1, col, 3), mass_v.reshape(-1, col),
                    cstarts)
            row_tot, _ = jax.lax.scan(
                body, jnp.zeros((rows,), jnp.float32), cols)
            return jnp.reshape(jnp.sum(mass_r * row_tot), (1,))
        return sm(pe_local, (S, S, S, S, R), S)

    for rows in set(row_sizes):
        progs[("pe", rows, True)] = make_pe(rows, mask_diag=True)
        progs[("pe", rows, False)] = make_pe(rows, mask_diag=False)
    return progs


def total_energy_sharded(state, eps2: float, mesh: Mesh,
                         axis: str = SHARD_AXIS,
                         max_prog_pairs: float = 3e11,
                         block_i: int = 256, block_u: int = 2048,
                         progress=None) -> float:
    """Total energy of a (possibly born-sharded) state, computed on the
    mesh as bounded per-device programs — no (N, 3) gather, no single-device
    N^2 program.  Returns a host float64.

    ``progress``: optional ``f(done, total, None)``, called after each
    pair-potential program."""
    if block_u % block_i:
        raise ValueError(f"block_u={block_u} must be a multiple of "
                         f"block_i={block_i}")
    p = mesh.shape[axis]
    n_real = state.n
    n_pad = round_up(n_real, p * block_u)
    state = pad_state_to(state, n_pad)
    c = n_pad // p
    chunks = _row_chunks(c, block_i, max_prog_pairs)
    progs = _energy_programs(mesh, axis, c, float(eps2),
                             tuple(s for _, s in chunks))
    sharding = NamedSharding(mesh, P(axis))
    pos = jax.device_put(state.pos, sharding)
    vel = jax.device_put(state.vel, sharding)
    mass = jax.device_put(state.mass, sharding)

    ke = float(np.asarray(progs["ke"](vel, mass), dtype=np.float64).sum())

    # Rotation plan over the halved sweep: (rotate?, weight, is_self).
    plan = [(False, 1.0, True)]                    # k = 0: self shard
    plan += [(True, 2.0, False)] * ((p - 1) // 2)  # k and P-k are equal
    if p % 2 == 0 and p > 1:
        plan += [(True, 1.0, False)]               # antipodal: both
        #                                            orderings already
        #                                            present across devices
    visiting = (pos, mass)
    pe = 0.0
    done, total = 0, len(plan) * len(chunks)
    for rotate, w, is_self in plan:
        if rotate:
            visiting = progs["rot"](*visiting)
        part = 0.0
        for off, rows in chunks:
            part += float(np.asarray(
                progs[("pe", rows, is_self)](pos, mass, *visiting,
                                             jnp.int32(off)),
                dtype=np.float64).sum())
            done += 1
            if progress is not None:
                progress(done, total, None)
        pe += w * part
    return ke - 0.5 * pe
