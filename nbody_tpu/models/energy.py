"""Energy / momentum diagnostics.

The reference has no conservation accounting at all (SURVEY.md section 5); the
rebuild adds it because the drift gate (`nbody validate`) is defined in terms of
total energy over 1k steps.  The pair potential consistent with the softened
force ``a_i += m_j r_ij / (|r|^2 + eps2)^{3/2}`` (``kernel.cu:9-29``) is the
Plummer-softened potential ``phi_ij = -m_i m_j / sqrt(|r|^2 + eps2)``.

Computed in float64 on host-side arrays by default (fp32 state is upcast), so
the diagnostic itself does not add noise to the drift measurement.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


# Past this many bodies the exact host-f64 sweep is infeasible (O(N^2)
# on the CPU); energy_f64 delegates to the bounded device path and
# Simulation routes mesh runs to parallel/energy.py.
MAX_HOST_ENERGY_N = 262144


def kinetic_energy(vel, mass) -> jax.Array:
    v2 = jnp.sum(vel * vel, axis=-1)
    return 0.5 * jnp.sum(mass * v2)


def potential_energy(pos, mass, eps2: float, chunk: int = 2048) -> jax.Array:
    """-1/2 sum_{i != j} m_i m_j / sqrt(|r_ij|^2 + eps2), chunked over i."""
    n = pos.shape[0]
    chunk = min(chunk, n)
    n_pad = -(-n // chunk) * chunk
    pad = n_pad - n
    pos_p = jnp.pad(pos, ((0, pad), (0, 0)))
    mass_p = jnp.pad(mass, (0, pad))

    j_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n_pad), 1)

    def body(carry, args):
        pos_c, mass_c, start = args
        r = pos_p[None, :, :] - pos_c[:, None, :]
        d2 = jnp.sum(r * r, axis=-1) + eps2
        inv = jax.lax.rsqrt(d2)
        # Mask the self-pair in place: its value m_i^2 * rsqrt(eps2) is
        # ~1000x the physical pair terms, so subtracting it after
        # accumulation would cancel catastrophically in fp32.
        i_ids = start + jax.lax.broadcasted_iota(
            jnp.int32, (pos_c.shape[0], 1), 0)
        inv = jnp.where(j_ids == i_ids, 0.0, inv)
        pe_c = jnp.sum(mass_c[:, None] * mass_p[None, :] * inv)
        return carry + pe_c, None

    starts = jnp.arange(0, n_pad, chunk, dtype=jnp.int32)
    chunks = (pos_p.reshape(-1, chunk, 3), mass_p.reshape(-1, chunk), starts)
    total, _ = jax.lax.scan(body, jnp.asarray(0.0, pos.dtype), chunks)
    return -0.5 * total


def total_energy(state, eps2: float) -> jax.Array:
    return kinetic_energy(state.vel, state.mass) + potential_energy(
        state.pos, state.mass, eps2)


def total_momentum(vel, mass) -> jax.Array:
    return jnp.sum(mass[:, None] * vel, axis=0)


@functools.partial(jax.jit, static_argnames=("eps2", "col_chunk"))
def _pe_rows(pos_rows, mass_rows, pos_all, mass_all, start, eps2,
             col_chunk=2048):
    """Device-side partial potential: the PE terms of ``pos_rows`` against
    ALL bodies, column-chunked (temporaries bounded to (rows, col_chunk)).
    Self-pairs masked by global index; zero-mass ghosts are inert."""
    n = pos_all.shape[0]
    i_ids = start + jax.lax.broadcasted_iota(
        jnp.int32, (pos_rows.shape[0], 1), 0)

    def body(carry, args):
        pos_c, mass_c, cstart = args
        r = pos_c[None, :, :] - pos_rows[:, None, :]
        d2 = jnp.sum(r * r, axis=-1) + eps2
        inv = jax.lax.rsqrt(d2)
        j_ids = cstart + jax.lax.broadcasted_iota(
            jnp.int32, (1, pos_c.shape[0]), 1)
        inv = jnp.where(j_ids == i_ids, 0.0, inv)
        return carry + jnp.sum(mass_rows[:, None] * mass_c[None, :] * inv), \
            None

    cstarts = jnp.arange(0, n, col_chunk, dtype=jnp.int32)
    cols = (pos_all.reshape(-1, col_chunk, 3),
            mass_all.reshape(-1, col_chunk), cstarts)
    total, _ = jax.lax.scan(body, jnp.asarray(0.0, pos_all.dtype), cols)
    return total


def total_energy_bounded(state, eps2: float,
                         row_chunk: "int | None" = None,
                         col_chunk: int = 2048,
                         max_prog_pairs: float = 3e11) -> float:
    """Total energy via bounded device programs (one per ``row_chunk`` of
    bodies), partials accumulated in float64 on host.

    The large-N companion of ``energy_f64``: the host-f64 path is O(N^2)
    on the CPU (hours past ~256k bodies).  Pairwise math is device
    float32 (adequate for drift diagnostics; each program's sum is an
    fp32 tree reduction, partials then combine in f64).

    ``row_chunk=None`` sizes rows so each program evaluates at most
    ``max_prog_pairs`` (rows x N) pairs, which bounds the device
    temporaries and the time of one program independently of N."""
    n = state.pos.shape[0]
    if row_chunk is None:
        row_chunk = max(1024, min(65536, int(max_prog_pairs // max(n, 1))))
    ke = float(kinetic_energy(state.vel, state.mass))
    pe = 0.0
    n_pad = -(-n // col_chunk) * col_chunk
    pos_all = jnp.pad(state.pos, ((0, n_pad - n), (0, 0)))
    mass_all = jnp.pad(state.mass, (0, n_pad - n))
    for s in range(0, n, row_chunk):
        rows = slice(s, min(s + row_chunk, n))
        pe += float(_pe_rows(pos_all[rows], mass_all[rows], pos_all,
                             mass_all, s, float(eps2), col_chunk=col_chunk))
    return ke - 0.5 * pe


_delegation_warned = False


def energy_f64(state, eps2: float,
               max_host_n: int = MAX_HOST_ENERGY_N) -> float:
    """Float64 host-side total energy (the drift-gate measurement).

    Above ``max_host_n`` bodies the exact host-f64 sweep is infeasible
    (O(N^2) on the CPU); delegates to ``total_energy_bounded`` (device
    f32 pairs, f64 partial combination) — the precision that matters for
    the 1e-3-scale drift gates at those N.  The accuracy-class change is
    warned ONCE per process so drift-gate callers see it."""
    n = state.pos.shape[0]
    if n > max_host_n:
        global _delegation_warned
        if not _delegation_warned:
            import warnings
            warnings.warn(
                f"energy_f64: N={n} > max_host_n={max_host_n}; delegating "
                f"to total_energy_bounded (device float32 pair math, "
                f"float64 partial combination) — accuracy class changes "
                f"from host-f64 to device-f32 pairs", stacklevel=2)
            _delegation_warned = True
        return total_energy_bounded(state, eps2)
    pos = np.asarray(state.pos, dtype=np.float64)
    vel = np.asarray(state.vel, dtype=np.float64)
    mass = np.asarray(state.mass, dtype=np.float64)
    ke = 0.5 * float(np.sum(mass * np.sum(vel * vel, axis=-1)))
    pe = 0.0
    n = pos.shape[0]
    # Bound the (chunk, N, 3) float64 temporary to ~400 MB.
    chunk = max(1, min(n, 16 * 1024 * 1024 // max(n, 1) + 1))
    for s in range(0, n, chunk):
        pc = pos[s:s + chunk]
        mc = mass[s:s + chunk]
        r = pos[None, :, :] - pc[:, None, :]
        d2 = np.sum(r * r, axis=-1) + eps2
        inv = 1.0 / np.sqrt(d2)
        pe += float(np.sum(mc[:, None] * mass[None, :] * inv))
        pe -= float(np.sum(mc * mc)) / np.sqrt(eps2)
    return ke - 0.5 * pe
