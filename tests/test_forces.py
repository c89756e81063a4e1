"""Force-backend correctness vs the NumPy float64 oracle.

Mirrors the reference's differential-testing strategy (validation.cpp:55-103):
device forces must match the independent CPU implementation within 1% relative
tolerance per component (validation.cpp:143-163 semantics, plus an absolute
floor for near-zero components).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nbody_tpu import SimConfig, compute_forces
from nbody_tpu.ops.forces_xla import forces_chunked, forces_nxn
from nbody_tpu.oracle.numpy_oracle import (
    assert_matches_oracle, oracle_forces)
from conftest import make_small_system

EPS2 = 0.002


@pytest.mark.parametrize("n", [64, 256, 1000])
def test_nxn_matches_oracle(n):
    pos, _, mass = make_small_system(n)
    acc = np.asarray(forces_nxn(jnp.asarray(pos), jnp.asarray(mass), EPS2))
    ref = oracle_forces(pos, mass, EPS2)
    assert_matches_oracle(acc, ref, "acc(nxn)")


@pytest.mark.parametrize("n,chunk", [(256, 64), (1000, 128), (512, 512)])
def test_chunked_matches_oracle(n, chunk):
    pos, _, mass = make_small_system(n, seed=1)
    acc = np.asarray(
        forces_chunked(jnp.asarray(pos), jnp.asarray(mass), EPS2, chunk=chunk))
    ref = oracle_forces(pos, mass, EPS2)
    assert_matches_oracle(acc, ref, "acc(chunked)")


def test_chunked_equals_nxn():
    """Two device implementations agree with each other tightly (the
    reference's two-kernel-family cross-check, SURVEY.md section 4)."""
    pos, _, mass = make_small_system(512, seed=2)
    a1 = np.asarray(forces_nxn(jnp.asarray(pos), jnp.asarray(mass), EPS2))
    a2 = np.asarray(
        forces_chunked(jnp.asarray(pos), jnp.asarray(mass), EPS2, chunk=128))
    np.testing.assert_allclose(a1, a2, rtol=1e-4, atol=1e-2)


def test_self_interaction_is_zero():
    """A single body feels no force: r=0 => zero contribution under softening
    (kernel.cu:17-27 behavior, which makes the missing i!=j guard safe)."""
    pos = jnp.zeros((8, 3), dtype=jnp.float32)
    mass = jnp.full((8,), 1e9, dtype=jnp.float32)
    # All bodies at the same point: every pair has r=0 => total force 0.
    acc = np.asarray(forces_nxn(pos, mass, EPS2))
    np.testing.assert_array_equal(acc, 0.0)


def test_ghost_bodies_contribute_nothing():
    """Zero-mass padding ghosts must not alter real bodies' forces."""
    pos, _, mass = make_small_system(100, seed=3)
    acc_plain = np.asarray(
        forces_chunked(jnp.asarray(pos), jnp.asarray(mass), EPS2, chunk=32))
    ghost_pos = np.concatenate([pos, np.zeros((28, 3), np.float32)])
    ghost_mass = np.concatenate([mass, np.zeros((28,), np.float32)])
    acc_ghost = np.asarray(forces_chunked(
        jnp.asarray(ghost_pos), jnp.asarray(ghost_mass), EPS2, chunk=32))[:100]
    # fp32 accumulation order differs with the padded matmul width; ghosts
    # must only perturb within rounding noise, not physically.
    np.testing.assert_allclose(acc_plain, acc_ghost, rtol=1e-4, atol=1e-3)


def test_two_body_analytic():
    """Analytic check: two unit-separated bodies, a = m / (1 + eps2)^1.5."""
    pos = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], dtype=jnp.float32)
    mass = jnp.asarray([2.0, 3.0], dtype=jnp.float32)
    acc = np.asarray(forces_nxn(pos, mass, EPS2))
    expect = 1.0 / (1.0 + EPS2) ** 1.5
    np.testing.assert_allclose(acc[0], [3.0 * expect, 0, 0], rtol=1e-5)
    np.testing.assert_allclose(acc[1], [-2.0 * expect, 0, 0], rtol=1e-5)


def test_pallas_rejects_non_f32():
    cfg = SimConfig(n_bodies=64, dtype="bfloat16")
    pos = jnp.zeros((64, 3), jnp.bfloat16)
    mass = jnp.ones((64,), jnp.bfloat16)
    with pytest.raises(ValueError, match="float32-only"):
        compute_forces(pos, mass, cfg, impl="pallas")


def test_xla_supports_f64():
    """float64 state runs through the XLA backend (science-accuracy mode)."""
    import jax
    pos, _, mass = make_small_system(128, seed=5, dtype=np.float64)
    with jax.enable_x64(True):
        acc = np.asarray(forces_chunked(
            jnp.asarray(pos, dtype=jnp.float64),
            jnp.asarray(mass, dtype=jnp.float64), EPS2, chunk=64))
    ref = oracle_forces(pos, mass, EPS2)
    np.testing.assert_allclose(acc, ref, rtol=1e-8, atol=1e-8)


def test_dispatch_auto():
    cfg = SimConfig(n_bodies=256, impl="auto")
    pos, _, mass = make_small_system(256, seed=4)
    acc = np.asarray(compute_forces(jnp.asarray(pos), jnp.asarray(mass), cfg))
    ref = oracle_forces(pos, mass, EPS2)
    assert_matches_oracle(acc, ref, "acc(auto)")


def test_forces_chunked_matmul_precision_is_highest():
    """Any contraction in forces_chunked must carry Precision.HIGHEST: a
    DEFAULT float32 dot may run in reduced precision (TF32 on the GPU's
    tensor cores), which would silently demote the exact-class XLA
    backend.  CPU runs DEFAULT in full f32, so only this lowering check
    (not a numeric gate) can catch a regression in CI.  (The direct-form
    sum lowers to no dot at all.)"""
    import functools
    import jax
    import jax.numpy as jnp
    from nbody_tpu.ops.forces_xla import forces_chunked
    low = jax.jit(functools.partial(forces_chunked, eps2=2e-3,
                                    chunk=128)).lower(
        jnp.ones((256, 3)), jnp.ones((256,)))
    dots = [l for l in low.as_text().splitlines() if "stablehlo.dot" in l]
    assert all("HIGHEST" in l for l in dots), dots


@pytest.mark.parametrize("seed", [8191, 3, 11])
def test_chunked_close_pair_stays_in_the_1pct_gate(seed):
    """A close pair far from the origin, offset along x only: the
    direct-form sum keeps every component inside the 1% gate against the
    f64 oracle.  (A matmul decomposition cancels |y_i| * rowsum(f) in the
    pair's y and z components there, and fails the gate.)"""
    pos, _, mass = make_small_system(512, seed=seed)
    pos[1] = pos[0] + np.float32([50.0, 0.0, 0.0])
    acc = np.asarray(forces_chunked(jnp.asarray(pos), jnp.asarray(mass),
                                    EPS2, chunk=128))
    assert_matches_oracle(acc, oracle_forces(pos, mass, EPS2),
                          "acc(chunked close pair)", abs_tol=1e-6)
