"""Energy / momentum diagnostics (absent in the reference; SURVEY.md §5)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nbody_tpu import SimConfig, SimState, run_steps
from nbody_tpu.models.energy import (
    energy_f64, kinetic_energy, potential_energy, total_momentum)
from conftest import make_small_system

EPS2 = 0.002


def test_two_body_potential_analytic():
    pos = jnp.asarray([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], jnp.float32)
    mass = jnp.asarray([2.0, 5.0], jnp.float32)
    pe = float(potential_energy(pos, mass, EPS2))
    expect = -2.0 * 5.0 / np.sqrt(25.0 + EPS2)
    # fp32 lax.rsqrt is an approximate (few-ulp) op
    np.testing.assert_allclose(pe, expect, rtol=1e-4)


def test_kinetic_energy():
    vel = jnp.asarray([[1.0, 0, 0], [0, 2.0, 0]], jnp.float32)
    mass = jnp.asarray([3.0, 4.0], jnp.float32)
    ke = float(kinetic_energy(vel, mass))
    np.testing.assert_allclose(ke, 0.5 * (3 * 1 + 4 * 4))


def test_energy_f64_matches_device_energy():
    pos, vel, mass = make_small_system(256, seed=60)
    state = SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                     acc=jnp.zeros((256, 3), jnp.float32),
                     mass=jnp.asarray(mass))
    e_host = energy_f64(state, EPS2)
    e_dev = float(kinetic_energy(state.vel, state.mass)
                  + potential_energy(state.pos, state.mass, EPS2))
    np.testing.assert_allclose(e_dev, e_host, rtol=1e-4)


def test_momentum_near_conserved():
    """Total momentum starts at 0 (v=0 init) and must stay near 0 relative
    to the momentum scale (forces are analytically antisymmetric; numeric
    asymmetry is rounding only)."""
    n = 256
    pos, vel, mass = make_small_system(n, seed=61)
    state = SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                     acc=jnp.zeros((n, 3), jnp.float32),
                     mass=jnp.asarray(mass))
    cfg = SimConfig(n_bodies=n, impl="xla_nxn")
    out = run_steps(state, cfg, 50)
    p = np.asarray(total_momentum(out.vel, out.mass))
    scale = float(np.sum(np.asarray(out.mass)
                         * np.linalg.norm(np.asarray(out.vel), axis=1)))
    assert np.linalg.norm(p) / scale < 1e-4


def test_padding_does_not_change_energy():
    from nbody_tpu.models.state import pad_state
    pos, vel, mass = make_small_system(100, seed=62)
    state = SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                     acc=jnp.zeros((100, 3), jnp.float32),
                     mass=jnp.asarray(mass))
    padded = pad_state(state, 64)  # 100 -> 128 with ghosts
    # f64 summation-order noise only
    np.testing.assert_allclose(energy_f64(padded, EPS2),
                               energy_f64(state, EPS2), rtol=1e-9)


def test_total_energy_bounded_matches_host_f64():
    """The bounded-program energy path (device f32 pairs, f64 partial
    combination) must agree with the exact host-f64 sweep to f32-level
    relative precision, including ragged row/col chunks."""
    from nbody_tpu.models.energy import energy_f64, total_energy_bounded
    n = 3000
    pos, vel, mass = make_small_system(n, seed=91)
    state = SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                     acc=jnp.zeros((n, 3), jnp.float32),
                     mass=jnp.asarray(mass))
    exact = energy_f64(state, 0.002)
    bounded = total_energy_bounded(state, 0.002, row_chunk=1024,
                                   col_chunk=256)
    assert abs(bounded - exact) / abs(exact) < 1e-5
    # The huge-N delegation threshold routes to the bounded path.
    delegated = energy_f64(state, 0.002, max_host_n=100)
    assert abs(delegated - exact) / abs(exact) < 1e-5


@pytest.mark.parametrize("row_chunk,col_chunk", [(1024, 2048), (777, 512),
                                                 (None, 2048)])
def test_total_energy_bounded_chunkings(row_chunk, col_chunk):
    """Row and column chunkings, ragged ones included, agree with the host
    f64 sweep."""
    from nbody_tpu.models.energy import energy_f64, total_energy_bounded
    n = 1500
    pos, vel, mass = make_small_system(n, seed=93)
    state = SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel) + 1.0,
                     acc=jnp.zeros((n, 3), jnp.float32),
                     mass=jnp.asarray(mass))
    exact = energy_f64(state, EPS2)
    bounded = total_energy_bounded(state, EPS2, row_chunk=row_chunk,
                                   col_chunk=col_chunk)
    assert abs(bounded - exact) / abs(exact) < 1e-5


# ---- sharded energy (parallel/energy.py): track_energy on a mesh ----

def _mesh_state(n, seed=70):
    import jax.numpy as _jnp
    pos, vel, mass = make_small_system(n, seed=seed)
    return SimState(pos=_jnp.asarray(pos), vel=_jnp.asarray(vel),
                    acc=_jnp.zeros((n, 3), _jnp.float32),
                    mass=_jnp.asarray(mass))


@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_total_energy_sharded_matches_host_all_parities(p):
    """The mesh energy sweep (halved ring, diagonal masked in place, f64
    host combination) matches the host-f64 oracle on odd, even, and
    single-device meshes."""
    from nbody_tpu.parallel.energy import total_energy_sharded
    from nbody_tpu.parallel.mesh import make_mesh
    state = _mesh_state(300)
    e_host = energy_f64(state, EPS2)
    e = total_energy_sharded(state, EPS2, make_mesh(p), block_i=8,
                             block_u=64)
    np.testing.assert_allclose(e, e_host, rtol=1e-5, err_msg=f"p={p}")


def test_total_energy_sharded_nondivisor_col_chunk():
    """c > 2048 with c % 2048 != 0 (block_u=1024, N=6144 on 2 shards ->
    c=3072) must not crash the column reshape (the col chunk must divide
    the shard size)."""
    from nbody_tpu.parallel.energy import total_energy_sharded
    from nbody_tpu.parallel.mesh import make_mesh
    state = _mesh_state(6144, seed=73)
    e_host = energy_f64(state, EPS2)
    e = total_energy_sharded(state, EPS2, make_mesh(2), block_i=256,
                             block_u=1024)
    np.testing.assert_allclose(e, e_host, rtol=1e-5)


def test_total_energy_sharded_bounded_split():
    """A tiny max_prog_pairs splits the sweep into many bounded programs
    (progress sees them) without changing the result beyond f32
    association noise."""
    from nbody_tpu.parallel.energy import total_energy_sharded
    from nbody_tpu.parallel.mesh import make_mesh
    state = _mesh_state(300, seed=71)
    mesh = make_mesh(4)
    e1 = total_energy_sharded(state, EPS2, mesh, block_i=8, block_u=64)
    calls = []
    e2 = total_energy_sharded(state, EPS2, mesh, block_i=8, block_u=64,
                              max_prog_pairs=2000,
                              progress=lambda d, t, a: calls.append((d, t)))
    assert calls and calls[-1][0] == calls[-1][1] >= 8
    np.testing.assert_allclose(e2, e1, rtol=1e-6)


def test_simulation_mesh_track_energy_routes_sharded(monkeypatch):
    """Past the host wall, track_energy on a mesh run must compute on the
    mesh (parallel/energy.py) — never gather the state to host f64."""
    import nbody_tpu.models.simulation as simmod
    import nbody_tpu.parallel.energy as penergy
    from nbody_tpu.models.simulation import Simulation
    from nbody_tpu.parallel.mesh import make_mesh

    def _boom(*a, **k):
        raise AssertionError("host energy_f64 used past the wall on a mesh")

    monkeypatch.setattr(simmod, "energy_f64", _boom)
    monkeypatch.setattr(penergy, "MAX_HOST_ENERGY_N", 64)
    sharded_calls = []
    real = penergy.total_energy_sharded

    def spy(state, eps2, mesh, **kw):
        kw.setdefault("block_i", 8)
        kw.setdefault("block_u", 64)
        sharded_calls.append(state.n)
        return real(state, eps2, mesh, **kw)

    monkeypatch.setattr(penergy, "total_energy_sharded", spy)
    n = 256
    state = _mesh_state(n, seed=72)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64)
    sim = Simulation(cfg, state=state, mesh=make_mesh(4))
    res = sim.run(n_steps=2, log_every=0, track_energy=True)
    assert sharded_calls == [n, n]
    assert res.energy_drift is not None and res.energy_drift < 1e-3
