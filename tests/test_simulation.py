"""Simulation driver: chunked run loop, watchdog, resume, energy tracking."""

import numpy as np
import jax.numpy as jnp
import pytest

from nbody_tpu import SimConfig, SimState
from nbody_tpu.io.checkpoint import save_checkpoint
from nbody_tpu.io.logger import RunLogger
from nbody_tpu.models.simulation import Simulation
from conftest import make_small_system


def make_state(n, seed=0):
    pos, vel, mass = make_small_system(n, seed=seed)
    return SimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass))


def test_run_reports_throughput():
    cfg = SimConfig(n_bodies=128, impl="xla_nxn")
    sim = Simulation(cfg, state=make_state(128, seed=70),
                     logger=RunLogger(quiet=True))
    res = sim.run(n_steps=30, log_every=10)
    assert res.steps_run == 30
    assert res.ms_per_step > 0
    assert sim.step_count == 30


def test_nan_watchdog_trips():
    cfg = SimConfig(n_bodies=64, impl="xla_nxn")
    state = make_state(64, seed=71)
    # Poison one position with inf: the next force evaluation propagates it.
    bad_pos = state.pos.at[0, 0].set(jnp.inf)
    sim = Simulation(cfg, state=state._replace(pos=bad_pos),
                     logger=RunLogger(quiet=True))
    with pytest.raises(FloatingPointError, match="non-finite"):
        sim.run(n_steps=5, log_every=1)


def test_energy_tracking():
    cfg = SimConfig(n_bodies=128, impl="xla_nxn", dt=0.001)
    sim = Simulation(cfg, state=make_state(128, seed=72),
                     logger=RunLogger(quiet=True))
    res = sim.run(n_steps=5, log_every=0, track_energy=True)
    assert res.energy_initial is not None and res.energy_final is not None
    assert res.energy_drift is not None and res.energy_drift < 0.1


def test_resume_classmethod(tmp_path):
    cfg = SimConfig(n_bodies=64, impl="xla_nxn")
    state = make_state(64, seed=73)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, state, step=7, cfg=cfg)
    sim = Simulation.resume(p, logger=RunLogger(quiet=True))
    assert sim.step_count == 7
    assert sim.cfg == cfg
    sim.run(n_steps=3, log_every=0)
    assert sim.step_count == 10


def test_sort_every_preserves_mass_multiset():
    cfg = SimConfig(n_bodies=256, impl="xla_nxn")
    state = make_state(256, seed=74)
    sim = Simulation(cfg, state=state, logger=RunLogger(quiet=True))
    sim.run(n_steps=6, log_every=0, sort_every=2)
    np.testing.assert_allclose(
        np.sort(np.asarray(sim.state.mass)),
        np.sort(np.asarray(state.mass)))


def test_checkpoint_path_without_cadence_saves_final(tmp_path):
    from nbody_tpu.io.checkpoint import load_checkpoint
    cfg = SimConfig(n_bodies=64, impl="xla_nxn")
    sim = Simulation(cfg, state=make_state(64, seed=76),
                     logger=RunLogger(quiet=True))
    p = str(tmp_path / "final.npz")
    sim.run(n_steps=4, log_every=0, checkpoint_path=p)
    state, step, _ = load_checkpoint(p)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(state.pos),
                                  np.asarray(sim.state.pos))


def test_kdk_simulation_primes_acc():
    cfg = SimConfig(n_bodies=64, impl="xla_nxn", integrator="kdk", dt=0.01)
    sim = Simulation(cfg, state=make_state(64, seed=75),
                     logger=RunLogger(quiet=True))
    # prime_kdk ran in __init__: acc must be nonzero before the first step.
    assert float(jnp.abs(sim.state.acc).max()) > 0
    sim.run(n_steps=3, log_every=0)


@pytest.mark.parametrize("integrator", ["reference", "kdk", "yoshida4"])
def test_kernel_integrators_match_xla(integrator, kernel_interpret):
    """The three integrators through the tiled kernel (interpret mode on
    the CPU) against the same run through XLA."""
    n = 256
    runs = {}
    for impl in ("pallas", "xla"):
        cfg = SimConfig(n_bodies=n, impl=impl, integrator=integrator,
                        block_i=32, block_j=64, chunk=64, dt=0.01)
        sim = Simulation(cfg, state=make_state(n, seed=77),
                         logger=RunLogger(quiet=True))
        assert sim.impl == impl
        sim.run(n_steps=3, log_every=0)
        runs[impl] = sim.state
    for leaf in ("pos", "vel", "acc"):
        np.testing.assert_allclose(
            np.asarray(getattr(runs["pallas"], leaf)),
            np.asarray(getattr(runs["xla"], leaf)),
            rtol=1e-4, atol=1e-3, err_msg=f"{integrator} {leaf}")


def test_mesh_simulation_matches_single_device():
    """Simulation on a 4-device mesh advances like the single-device
    run."""
    from nbody_tpu.parallel.mesh import make_mesh
    n = 256
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64)
    mesh_sim = Simulation(cfg, state=make_state(n, seed=81),
                          logger=RunLogger(quiet=True), mesh=make_mesh(4))
    single = Simulation(cfg, state=make_state(n, seed=81),
                        logger=RunLogger(quiet=True))
    mesh_sim.run(n_steps=6, log_every=3)
    single.run(n_steps=6, log_every=3)
    np.testing.assert_allclose(np.asarray(mesh_sim.state.pos),
                               np.asarray(single.state.pos),
                               rtol=1e-4, atol=1.0)


def test_chunks_end_at_modulo_trigger_boundaries(tmp_path):
    """A log cadence that does not divide the checkpoint cadence must not
    skip done%cadence==0 triggers: chunks end exactly at checkpoint
    boundaries."""
    import os
    n = 256
    cfg = SimConfig(n_bodies=n, impl="xla_nxn")
    sim = Simulation(cfg, state=make_state(n, seed=82),
                     logger=RunLogger(quiet=True))
    calls = []
    orig = sim._run_chunk
    sim._run_chunk = lambda k: (calls.append(k), orig(k))[1]
    ck = str(tmp_path / "ck.npz")
    sim.run(n_steps=10, log_every=3, checkpoint_path=ck, checkpoint_every=5)
    # Cumulative step counts must include every multiple of 5.
    sums = [sum(calls[:i + 1]) for i in range(len(calls))]
    assert 5 in sums and 10 in sums and max(calls) <= 3
    assert os.path.exists(ck)


def test_auto_log_every_targets_chunk_duration():
    """log_every=None sizes chunks to ~0.5 s of device work (every chunk
    boundary syncs the device) while capping the line count at
    ~50/run."""
    from nbody_tpu.models.simulation import auto_log_every
    # Small N: duration-driven (0.5 s at 300 G/s), snapped to a divisor
    # of n_steps so every chunk shares ONE compiled program (a ragged
    # tail is a fresh compile).
    assert auto_log_every(SimConfig(n_bodies=8192), 100_000) == 2500
    assert auto_log_every(SimConfig(n_bodies=8192), 20_000) == 2500
    # No divisor >= target: the largest half-target divisor serves.
    assert auto_log_every(SimConfig(n_bodies=4096), 10_000) == 5000
    # Prime step counts fall back to the raw target (one ragged tail).
    assert auto_log_every(SimConfig(n_bodies=8192), 99_991) == 2235
    # Large N: one step exceeds the target; line cap takes over.
    assert auto_log_every(SimConfig(n_bodies=1 << 20), 10_000) == 200
    assert auto_log_every(SimConfig(n_bodies=1 << 20), 20) == 1


def test_banner_names_impl_and_backend(capsys):
    """The run banner names the force path that served the run and the
    backend it ran on."""
    import jax
    cfg = SimConfig(n_bodies=128, impl="xla")
    sim = Simulation(cfg, state=make_state(128, seed=91),
                     logger=RunLogger())
    sim.run(n_steps=2)
    out = capsys.readouterr().out
    assert "impl=xla integrator=" in out
    assert f"backend={jax.default_backend()}" in out
