"""End-to-end dtype support (float64 / bfloat16 state).

The reference is float32-only (float4 state); the rebuild adds float64 —
the precision control for the drift-gate analysis — and
bfloat16 storage.  Backend matrix (README): the XLA force paths follow the
input dtype; Pallas kernels are float32-only and raise a clear error.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nbody_tpu import SimConfig, SimState, init_state, run_steps
from nbody_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from nbody_tpu.models.energy import energy_f64
from nbody_tpu.ops.forces import compute_forces, resolve_impl
from nbody_tpu.oracle.numpy_oracle import oracle_run


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def test_f64_full_run_and_checkpoint_roundtrip(tmp_path, x64):
    """init -> run -> energy -> checkpoint -> resume, all in float64."""
    cfg = SimConfig(n_bodies=192, impl="xla", chunk=64, dtype="float64",
                    steps=10)
    state = init_state(cfg)
    assert state.pos.dtype == jnp.float64 and state.mass.dtype == jnp.float64
    out = run_steps(state, cfg, 10)
    assert out.pos.dtype == jnp.float64
    e = energy_f64(out, cfg.eps2)
    assert np.isfinite(e)
    # f64 device run tracks the f64 oracle far tighter than fp32 could.
    rpos, rvel, _ = oracle_run(np.asarray(state.pos), np.asarray(state.vel),
                               np.asarray(state.mass), cfg.eps2, cfg.dt, 10)
    np.testing.assert_allclose(np.asarray(out.pos), rpos, rtol=1e-9,
                               atol=1e-6)
    ck = str(tmp_path / "ck64.npz")
    save_checkpoint(ck, out, step=10, cfg=cfg)
    restored, step, rcfg = load_checkpoint(ck)
    assert step == 10 and rcfg.dtype == "float64"
    assert restored.pos.dtype == jnp.float64
    np.testing.assert_array_equal(np.asarray(restored.pos),
                                  np.asarray(out.pos))


def test_f64_forces_accuracy(x64):
    """f64 XLA forces match the f64 oracle to near machine precision."""
    from nbody_tpu.oracle.numpy_oracle import oracle_forces
    r = np.random.default_rng(5)
    pos = r.uniform(-1e5, 1e5, (256, 3))
    mass = r.uniform(1e5, 1e9, (256,))
    cfg = SimConfig(n_bodies=256, impl="xla", chunk=64, dtype="float64")
    acc = np.asarray(compute_forces(jnp.asarray(pos), jnp.asarray(mass),
                                    cfg, impl="xla"))
    ref = oracle_forces(pos, mass, cfg.eps2)
    err = np.abs(acc - ref) / (np.abs(ref) + 1e-30)
    assert np.percentile(err, 99.9) < 1e-12


def test_bf16_state_runs_finite():
    """bfloat16 state executes end-to-end (storage tier; at reference
    domain scale its 8-bit mantissa is physically meaningless — documented,
    not gated on accuracy)."""
    cfg = SimConfig(n_bodies=128, impl="xla", chunk=64, dtype="bfloat16")
    state = init_state(cfg)
    assert state.pos.dtype == jnp.bfloat16
    out = run_steps(state, cfg, 3)
    assert out.pos.dtype == jnp.bfloat16
    assert np.all(np.isfinite(np.asarray(out.pos, dtype=np.float32)))


def test_auto_impl_routes_non_f32_to_xla():
    assert resolve_impl(SimConfig(n_bodies=65536, dtype="float64")) == "xla"
    assert resolve_impl(SimConfig(n_bodies=1024, dtype="bfloat16")) \
        == "xla_nxn"


def test_auto_impl_prefers_kernel_on_gpu(monkeypatch):
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_impl(SimConfig(n_bodies=65536)) == "pallas"
    assert resolve_impl(SimConfig(n_bodies=8192)) == "pallas"
    # Non-f32 state never reaches the float32-only kernel.
    assert resolve_impl(SimConfig(n_bodies=8192, dtype="float64")) == "xla"


def test_pallas_rejects_non_f32():
    cfg = SimConfig(n_bodies=128, dtype="bfloat16")
    state = init_state(cfg)
    with pytest.raises(ValueError, match="float32-only"):
        compute_forces(state.pos, state.mass, cfg, impl="pallas")


def test_cli_dtype_f64(tmp_path, capsys, x64):
    """--dtype float64 end-to-end through the CLI (enables x64; the x64
    fixture restores the flag so later tests aren't run in x64 mode)."""
    from nbody_tpu.cli import main
    ck = str(tmp_path / "c.npz")
    rc = main(["run", "--n", "96", "--steps", "4", "--impl", "xla",
               "--chunk", "32", "--dtype", "float64", "--energy",
               "--checkpoint", ck, "--quiet"])
    assert rc == 0
    with np.load(ck) as z:
        assert z["pos"].dtype == np.float64
