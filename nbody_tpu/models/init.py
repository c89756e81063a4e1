"""Initial-condition generation.

Mirrors the reference's ``fill_with_random4`` / ``fill_with_zeroes*`` init
(``utils.cpp:9-37``): positions uniform per-axis in [-MAX_X, MAX_X], masses
uniform in [MIN_W, MAX_W], velocities and accelerations zero
(``main.cpp:254-272``).  The reference uses unseeded libc ``rand()`` (so it is
accidentally deterministic across runs, ``utils.cpp:6``); here determinism is
explicit via a JAX PRNG key.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig
from .state import SimState


def init_state(cfg: SimConfig, key: "jax.Array | None" = None,
               sharding=None) -> SimState:
    """Uniform random initial conditions matching utils.cpp:30-37 ranges.

    ``sharding``: optional ``jax.sharding.Sharding`` — when given, the
    state is GENERATED directly into that layout (``jit`` with
    ``out_shardings``), so no single-device copy of the whole state is
    made and then redistributed.  Values are identical to the unsharded
    init (the PRNG stream does not depend on layout)."""
    if key is None:
        key = jax.random.key(cfg.seed)

    def make(key):
        kpos, kmass = jax.random.split(key)
        dtype = cfg.jnp_dtype
        n = cfg.n_bodies
        pos = jax.random.uniform(
            kpos, (n, 3), dtype=jnp.float32,
            minval=-cfg.max_pos, maxval=cfg.max_pos).astype(dtype)
        mass = jax.random.uniform(
            kmass, (n,), dtype=jnp.float32,
            minval=cfg.min_mass, maxval=cfg.max_mass).astype(dtype)
        zeros = jnp.zeros((n, 3), dtype=dtype)
        return SimState(pos=pos, vel=zeros, acc=zeros, mass=mass)

    if sharding is not None:
        return jax.jit(make, out_shardings=SimState(
            pos=sharding, vel=sharding, acc=sharding, mass=sharding))(key)
    return make(key)


def plummer_state(cfg: SimConfig, key: "jax.Array | None" = None,
                  scale_radius: "float | None" = None) -> SimState:
    """Plummer-sphere initial conditions — a physically structured alternative
    to the reference's uniform box (goes beyond the reference; useful for
    energy-conservation studies where the uniform box collapses violently)."""
    if key is None:
        key = jax.random.key(cfg.seed)
    a = scale_radius if scale_radius is not None else cfg.max_pos / 10.0
    kr, kdir, kmass = jax.random.split(key, 3)
    n = cfg.n_bodies
    dtype = cfg.jnp_dtype
    # Inverse-CDF sampling of the Plummer cumulative mass profile.
    u = jax.random.uniform(kr, (n,), minval=1e-6, maxval=1.0 - 1e-6)
    r = a / jnp.sqrt(u ** (-2.0 / 3.0) - 1.0)
    direction = jax.random.normal(kdir, (n, 3))
    direction = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
    pos = (r[:, None] * direction).astype(dtype)
    mass = jax.random.uniform(
        kmass, (n,), minval=cfg.min_mass, maxval=cfg.max_mass).astype(dtype)
    zeros = jnp.zeros((n, 3), dtype=dtype)
    return SimState(pos=pos, vel=zeros, acc=zeros, mass=mass)


def _plummer_speed_fraction(key, n):
    """Sample q = v/v_esc from the isotropic Plummer distribution
    function, f(q) dq ∝ q² (1-q²)^{7/2} (Aarseth, Hénon & Wielen 1974) —
    inverse-CDF via a static 513-point table (compiler-friendly; the
    classic rejection loop is data-dependent control flow)."""
    q = jnp.linspace(0.0, 1.0, 513)
    pdf = q ** 2 * (1.0 - q ** 2) ** 3.5
    cdf = jnp.cumsum(pdf)
    cdf = cdf / cdf[-1]
    u = jax.random.uniform(key, (n,))
    return jnp.interp(u, cdf, q)


def _isotropic_directions(key, n):
    d = jax.random.normal(key, (n, 3))
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def plummer_virial_state(cfg: SimConfig, key: "jax.Array | None" = None,
                         scale_radius: "float | None" = None) -> SimState:
    """Plummer sphere in virial equilibrium: positions as
    ``plummer_state``, speeds sampled from the exact isotropic Plummer
    distribution function as a fraction of the local escape speed
    ``v_esc(r) = sqrt(2 M_tot / sqrt(r² + a²))`` (force-law units: no G,
    mass absorbed — ``kernel.cu:9-29``).  Unlike the cold spheres (which
    collapse violently), this cluster is statistically stationary — the
    right backdrop for long-horizon integrator studies
    (examples/orbit.py)."""
    if key is None:
        key = jax.random.key(cfg.seed)
    kpos, kq, kdir = jax.random.split(key, 3)
    base = plummer_state(cfg, key=kpos, scale_radius=scale_radius)
    a = scale_radius if scale_radius is not None else cfg.max_pos / 10.0
    n = cfg.n_bodies
    m_tot = jnp.sum(base.mass)
    r = jnp.linalg.norm(base.pos, axis=-1)
    v_esc = jnp.sqrt(2.0 * m_tot / jnp.sqrt(r * r + a * a))
    speed = _plummer_speed_fraction(kq, n) * v_esc
    vel = (speed[:, None] * _isotropic_directions(kdir, n)).astype(
        base.pos.dtype)
    # Zero the bulk drift so the cluster stays centered (the DF sample
    # has O(1/sqrt(N)) net momentum).
    vel = vel - jnp.sum(base.mass[:, None] * vel, axis=0) / m_tot
    return base._replace(vel=vel)


def disk_state(cfg: SimConfig, key: "jax.Array | None" = None,
               scale_radius: "float | None" = None,
               thickness: float = 0.05) -> SimState:
    """Cold rotating disk: bodies uniform-in-area over a thin disk of
    radius ``a`` in the xy-plane (Gaussian z, sigma = thickness·a), on
    approximately circular orbits — tangential speed from the enclosed
    mass of the uniform disk treated spherically,
    ``v_c(r) = sqrt(M_tot (r/a)² / r)``.  The spherical-enclosed-mass
    approximation is deliberate (a self-consistent disk DF is far out of
    scope): the disk shears into rings and spiral structure over a few
    rotation periods, which is exactly what it's for — a structured,
    angular-momentum-rich demo (`--init disk`; the angular-momentum
    diagnostic `analysis.angular_momentum` tracks L_z conservation)."""
    if key is None:
        key = jax.random.key(cfg.seed)
    kr, kphi, kz, kmass = jax.random.split(key, 4)
    a = scale_radius if scale_radius is not None else cfg.max_pos / 4.0
    n = cfg.n_bodies
    dtype = cfg.jnp_dtype
    u = jax.random.uniform(kr, (n,), minval=1e-4, maxval=1.0)
    r = a * jnp.sqrt(u)                      # uniform surface density
    phi = jax.random.uniform(kphi, (n,), minval=0.0, maxval=2.0 * jnp.pi)
    z = thickness * a * jax.random.normal(kz, (n,))
    pos = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z],
                    axis=-1).astype(dtype)
    mass = jax.random.uniform(
        kmass, (n,), minval=cfg.min_mass, maxval=cfg.max_mass).astype(dtype)
    m_tot = jnp.sum(mass)
    v_c = jnp.sqrt(m_tot * u / r)            # M_enc/r with M_enc = M·(r/a)²
    vel = jnp.stack([-v_c * jnp.sin(phi), v_c * jnp.cos(phi),
                     jnp.zeros_like(v_c)], axis=-1).astype(dtype)
    zeros = jnp.zeros((n, 3), dtype=dtype)
    return SimState(pos=pos, vel=vel, acc=zeros, mass=mass)


def collision_state(cfg: SimConfig, key: "jax.Array | None" = None,
                    separation: "float | None" = None,
                    impact_parameter: "float | None" = None,
                    approach_fraction: float = 0.5) -> SimState:
    """Two virialized Plummer spheres on a colliding course: centers at
    ±separation/2 along x (default 8 scale radii apart), offset by an
    impact parameter along y (default one scale radius), approaching at
    ``approach_fraction`` of the mutual parabolic speed
    ``sqrt(2 M_tot / d)``.  Total momentum is exactly zero by
    construction.  The classic merger demo (`--init collision`)."""
    if key is None:
        key = jax.random.key(cfg.seed)
    k1, k2 = jax.random.split(key)
    n = cfg.n_bodies
    n1 = n // 2
    a = cfg.max_pos / 10.0
    d = separation if separation is not None else 8.0 * a
    b = impact_parameter if impact_parameter is not None else a
    c1 = cfg.replace(n_bodies=n1)
    c2 = cfg.replace(n_bodies=n - n1)
    s1 = plummer_virial_state(c1, key=k1, scale_radius=a)
    s2 = plummer_virial_state(c2, key=k2, scale_radius=a)
    off1 = jnp.array([-d / 2.0, -b / 2.0, 0.0], dtype=s1.pos.dtype)
    off2 = jnp.array([+d / 2.0, +b / 2.0, 0.0], dtype=s2.pos.dtype)
    m_tot = jnp.sum(s1.mass) + jnp.sum(s2.mass)
    v = approach_fraction * jnp.sqrt(2.0 * m_tot / d)
    # Momentum-balanced approach velocities (m1·v1 = m2·v2).
    m1, m2 = jnp.sum(s1.mass), jnp.sum(s2.mass)
    v1 = jnp.array([+v * m2 / m_tot, 0.0, 0.0], dtype=s1.pos.dtype)
    v2 = jnp.array([-v * m1 / m_tot, 0.0, 0.0], dtype=s2.pos.dtype)
    pos = jnp.concatenate([s1.pos + off1, s2.pos + off2])
    vel = jnp.concatenate([s1.vel + v1, s2.vel + v2])
    mass = jnp.concatenate([s1.mass, s2.mass])
    zeros = jnp.zeros((n, 3), dtype=pos.dtype)
    return SimState(pos=pos, vel=vel, acc=zeros, mass=mass)


# CLI-facing registry (`--init`); "uniform" is handled by the callers
# (Simulation inits directly, born sharded on a mesh) rather than through
# this map.
INIT_MAKERS = {
    "plummer": plummer_state,
    "plummer-virial": plummer_virial_state,
    "disk": disk_state,
    "collision": collision_state,
}
