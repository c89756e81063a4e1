"""Multi-device ring / all-gather sharded path, on 8 virtual CPU devices.

The reference has no distributed story (single GPU, SURVEY.md section 2.3);
this is the rebuild's mesh scaling layer.  Correctness bar: the sharded result
must match the single-device path and the oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nbody_tpu import SimConfig, SimState, run_steps
from nbody_tpu.parallel.mesh import make_mesh, shard_state
from nbody_tpu.parallel.ring import run_steps_sharded, shard_padding
from nbody_tpu.oracle.numpy_oracle import assert_matches_oracle, oracle_run
from conftest import make_small_system


def make_state(n, seed=0):
    pos, vel, mass = make_small_system(n, seed=seed)
    return SimState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        acc=jnp.zeros((n, 3), jnp.float32), mass=jnp.asarray(mass)), pos, vel, mass


def test_mesh_has_8_virtual_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_sharded_matches_single_device(comm):
    n, steps = 512, 10
    state, *_ = make_state(n, seed=20)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64)
    mesh = make_mesh()
    out_sharded = run_steps_sharded(
        state, cfg, mesh, steps, impl="xla", comm=comm)
    out_single = run_steps(state, cfg, steps, impl="xla")
    np.testing.assert_allclose(
        np.asarray(out_sharded.pos), np.asarray(out_single.pos),
        rtol=1e-4, atol=1.0)
    np.testing.assert_allclose(
        np.asarray(out_sharded.vel), np.asarray(out_single.vel),
        rtol=1e-4, atol=1e-2)


def test_sharded_matches_oracle():
    n, steps = 512, 20
    state, pos, vel, mass = make_state(n, seed=21)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64)
    mesh = make_mesh()
    out = run_steps_sharded(state, cfg, mesh, steps, impl="xla", comm="ring")
    rpos, rvel, _ = oracle_run(pos, vel, mass, cfg.eps2, cfg.dt, steps)
    assert_matches_oracle(np.asarray(out.pos), rpos, "pos(ring)", abs_tol=1.0)
    assert_matches_oracle(np.asarray(out.vel), rvel, "vel(ring)", abs_tol=1e-2)


def test_sharded_kdk_matches_oracle():
    """run_steps_sharded must honor cfg.integrator: a KDK
    config runs KDK on the sharded path, matching the KDK oracle twin."""
    from nbody_tpu.ops.step import prime_kdk
    n, steps = 512, 15
    state, pos, vel, mass = make_state(n, seed=22)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64, integrator="kdk")
    state = prime_kdk(state, cfg, impl="xla")
    mesh = make_mesh()
    out = run_steps_sharded(state, cfg, mesh, steps, impl="xla", comm="ring")
    rpos, rvel, _ = oracle_run(pos, vel, mass, cfg.eps2, cfg.dt, steps,
                               integrator="kdk")
    assert_matches_oracle(np.asarray(out.pos), rpos, "pos(kdk)", abs_tol=1.0)
    assert_matches_oracle(np.asarray(out.vel), rvel, "vel(kdk)", abs_tol=1e-2)


def test_sharded_yoshida4_matches_oracle():
    """yoshida4 on the sharded ring path: three force sweeps per step,
    each riding the same ppermute ring, vs the NumPy yoshida4 twin."""
    from nbody_tpu.ops.step import prime_kdk
    n, steps = 512, 10
    state, pos, vel, mass = make_state(n, seed=23)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64, integrator="yoshida4")
    state = prime_kdk(state, cfg, impl="xla")
    mesh = make_mesh()
    out = run_steps_sharded(state, cfg, mesh, steps, impl="xla", comm="ring")
    rpos, rvel, _ = oracle_run(pos, vel, mass, cfg.eps2, cfg.dt, steps,
                               integrator="yoshida4")
    assert_matches_oracle(np.asarray(out.pos), rpos, "pos(y4)", abs_tol=1.0)
    assert_matches_oracle(np.asarray(out.vel), rvel, "vel(y4)", abs_tol=1e-2)


def test_sharded_with_padding():
    """N not divisible by P: ghosts carry the remainder."""
    n = 500  # pads to 512 on 8 devices with block multiples of 8
    state, pos, vel, mass = make_state(n, seed=22)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64, block_i=8, block_j=128)
    mesh = make_mesh()
    assert shard_padding(cfg, 8) % 8 == 0
    out = run_steps_sharded(state, cfg, mesh, 5, impl="xla", comm="ring")
    assert out.n == n
    rpos, _, _ = oracle_run(pos, vel, mass, cfg.eps2, cfg.dt, 5)
    assert_matches_oracle(np.asarray(out.pos), rpos, "pos(pad)", abs_tol=1.0)


@pytest.mark.parametrize("comm", ["ring", "allgather"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_sharded_kernel_matches_oracle(p, comm, kernel_interpret):
    """The tiled kernel as each device's local sweep (interpret mode on
    the CPU), <= 128 bodies per device (conftest envelope)."""
    n, steps = 64 * p, 2
    state, pos, vel, mass = make_state(n, seed=23 + p)
    cfg = SimConfig(n_bodies=n, impl="pallas", block_i=16, block_j=32)
    out = run_steps_sharded(state, cfg, make_mesh(p), steps, impl="pallas",
                            comm=comm)
    rpos, _, racc = oracle_run(pos, vel, mass, cfg.eps2, cfg.dt, steps)
    assert_matches_oracle(np.asarray(out.pos), rpos,
                          f"pos(kernel {comm} p={p})", abs_tol=1.0)
    assert_matches_oracle(np.asarray(out.acc), racc,
                          f"acc(kernel {comm} p={p})", abs_tol=1e-4)


def test_sharded_kernel_matches_single_device(kernel_interpret):
    """Sharded kernel ring == single-device kernel (same physics; the sum
    grouping differs only within the fp32 contract)."""
    n, steps = 256, 3
    state, *_ = make_state(n, seed=28)
    cfg = SimConfig(n_bodies=n, impl="pallas", block_i=16, block_j=32)
    out_sharded = run_steps_sharded(state, cfg, make_mesh(4), steps,
                                    impl="pallas", comm="ring")
    out_single = run_steps(state, cfg, steps, impl="pallas")
    np.testing.assert_allclose(
        np.asarray(out_sharded.pos), np.asarray(out_single.pos),
        rtol=1e-4, atol=1.0)


def test_shard_state_placement():
    state, *_ = make_state(512, seed=24)
    mesh = make_mesh()
    sharded = shard_state(state, mesh)
    assert len(sharded.pos.sharding.device_set) == 8


def test_init_born_sharded_matches_unsharded():
    """init_state(sharding=...) generates directly into the sharded
    layout (no single-device (N,3) buffer) with IDENTICAL values: the
    PRNG stream does not depend on layout."""
    from jax.sharding import NamedSharding, PartitionSpec
    from nbody_tpu.models.init import init_state
    from nbody_tpu.parallel.mesh import SHARD_AXIS
    cfg = SimConfig(n_bodies=512, impl="xla")
    sh = NamedSharding(make_mesh(8), PartitionSpec(SHARD_AXIS))
    s_sharded = init_state(cfg, sharding=sh)
    s_plain = init_state(cfg)
    for k in ("pos", "vel", "acc", "mass"):
        arr = getattr(s_sharded, k)
        assert arr.sharding.is_equivalent_to(sh, arr.ndim), k
        np.testing.assert_array_equal(np.asarray(arr),
                                      np.asarray(getattr(s_plain, k)), k)


def test_resume_checkpoint_onto_mesh(tmp_path):
    """A single-device checkpoint resumed onto a mesh keeps its step count
    and continues like the single-device run (ring association
    tolerance)."""
    from nbody_tpu.io.logger import RunLogger
    from nbody_tpu.models.simulation import Simulation
    ckpt = str(tmp_path / "one.npz")
    cfg = SimConfig(n_bodies=256, impl="xla", chunk=64)
    Simulation(cfg).run(n_steps=2, log_every=0, checkpoint_path=ckpt)
    on_mesh = Simulation.resume(ckpt, logger=RunLogger(quiet=True),
                                mesh=make_mesh(2))
    single = Simulation.resume(ckpt, logger=RunLogger(quiet=True))
    assert on_mesh.step_count == single.step_count == 2
    got = on_mesh.run(n_steps=2, log_every=0).state
    want = single.run(n_steps=2, log_every=0).state
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(want.pos),
                               rtol=1e-4, atol=1.0)


def test_bad_comm_raises():
    state, *_ = make_state(64, seed=25)
    cfg = SimConfig(n_bodies=64)
    mesh = make_mesh()
    with pytest.raises(ValueError, match="comm"):
        run_steps_sharded(state, cfg, mesh, 1, comm="bogus")


def test_prime_kdk_sharded_matches_single_device(kernel_interpret):
    """Mesh KDK priming: prime_kdk_sharded seeds a(x_0) WITHOUT gathering
    the state to one device, and its acc matches the single-device primer
    within the sharded association tolerance for the XLA and kernel
    sweeps."""
    from nbody_tpu.ops.step import prime_kdk
    from nbody_tpu.parallel.ring import prime_kdk_sharded
    n = 512
    state, *_ = make_state(n, seed=27)
    mesh = make_mesh()
    for impl in ("xla", "pallas"):
        cfg = SimConfig(n_bodies=n, impl=impl, chunk=64, block_i=16,
                        block_j=32, integrator="kdk")
        single = prime_kdk(state, cfg, impl=impl)
        sharded = prime_kdk_sharded(state, cfg, mesh, impl=impl)
        # Association differs (per-shard ring partials vs one fused
        # sweep), so f32 agreement is ~1e-5 relative with a small
        # absolute floor for near-cancelling components.
        np.testing.assert_allclose(
            np.asarray(sharded.acc), np.asarray(single.acc),
            rtol=1e-4, atol=1e-3, err_msg=impl)
        np.testing.assert_array_equal(np.asarray(sharded.pos),
                                      np.asarray(state.pos))


def test_simulation_mesh_kdk_primes_on_mesh(monkeypatch):
    """Simulation(mesh=...) with a KDK-composed integrator must never
    call the single-device primer (it would gather the born-sharded
    state and run a one-device N^2 eval)."""
    import nbody_tpu.models.simulation as simmod
    from nbody_tpu.models.simulation import Simulation

    def _boom(*a, **k):
        raise AssertionError("single-device prime_kdk used on a mesh run")

    monkeypatch.setattr(simmod, "prime_kdk", _boom)
    n = 512
    state, pos, vel, mass = make_state(n, seed=28)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64,
                    integrator="yoshida4")
    sim = Simulation(cfg, state=state, mesh=make_mesh())
    res = sim.run(n_steps=3, log_every=0)
    rpos, _, _ = oracle_run(pos, vel, mass, cfg.eps2, cfg.dt, 3,
                            integrator="yoshida4")
    assert_matches_oracle(np.asarray(res.state.pos), rpos,
                          "pos(mesh yoshida4)", abs_tol=1.0)


def test_sharded_chunk_programs_cached():
    """run_steps_sharded / run_trajectory_frames_sharded must reuse ONE
    jitted program per (mesh, cfg, n_steps, impl, comm) — a fresh jit
    wrapper per chunk would retrace at every chunk boundary."""
    from nbody_tpu.parallel.ring import (_sharded_frames_program,
                                         _sharded_run_program,
                                         run_trajectory_frames_sharded)
    n = 256
    state, *_ = make_state(n, seed=30)
    cfg = SimConfig(n_bodies=n, impl="xla", chunk=64)
    mesh = make_mesh(4)
    h0 = _sharded_run_program.cache_info().hits
    run_steps_sharded(state, cfg, mesh, 2, impl="xla")
    run_steps_sharded(state, cfg, mesh, 2, impl="xla")
    assert _sharded_run_program.cache_info().hits > h0
    # Camera rides as a TRACED operand: two different views hit the same
    # cached program yet render different frames.
    cfg_v = cfg.replace(viz_width=32, viz_height=32, viz_every=1)
    _, f1 = run_trajectory_frames_sharded(state, cfg_v, mesh, 1,
                                          impl="xla", view=(100.0, 0, 0))
    h1 = _sharded_frames_program.cache_info().hits
    _, f2 = run_trajectory_frames_sharded(state, cfg_v, mesh, 1,
                                          impl="xla",
                                          view=(200000.0, 0, 0))
    assert _sharded_frames_program.cache_info().hits > h1
    assert not np.array_equal(np.asarray(f1), np.asarray(f2))
