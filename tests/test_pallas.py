"""The tiled force kernel (ops/forces_pallas.py).

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``);
compiled, it runs only on the GPU (the ``gpu``-marked tests, and
chip_smoke.py).  The reference cross-checks its two kernel families against
each other and against the CPU oracle (SURVEY.md section 4); here the kernel
must match the f64 oracle and the XLA backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_tpu.config import DEFAULT_BLOCK_I, DEFAULT_BLOCK_J
from nbody_tpu.ops.forces_pallas import forces_pallas, rect_forces_pallas
from nbody_tpu.ops.forces_xla import forces_chunked, forces_nxn
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, relative_mismatch)
from conftest import make_small_system

EPS2 = 0.002

# Power-of-two (block_i, block_j) shapes: square, tall, wide, and blocks
# larger than some of the N below (all-ghost tails).
BLOCKS = [(16, 16), (32, 64), (64, 32), (128, 16), (8, 128)]


def _rect_oracle(pos_i, pos_j, mass_j, eps2):
    """f64 forces of set j on set i, straight from the force law."""
    pi = pos_i.astype(np.float64)
    pj = pos_j.astype(np.float64)
    r = pj[None, :, :] - pi[:, None, :]
    d2 = np.sum(r * r, axis=-1) + eps2
    f = mass_j.astype(np.float64)[None, :] / (d2 * np.sqrt(d2))
    return np.sum(f[:, :, None] * r, axis=1)


@pytest.mark.parametrize("bi,bj", BLOCKS)
@pytest.mark.parametrize("n", [1, 2, 7, 33, 100, 128, 255, 257, 500, 513])
def test_kernel_matches_oracle(n, bi, bj):
    """N of 1, odd sizes, non-multiples of a block, several j-tiles."""
    pos, _, mass = make_small_system(n, seed=n)
    acc = np.asarray(forces_pallas(jnp.asarray(pos), jnp.asarray(mass), EPS2,
                                   block_i=bi, block_j=bj, interpret=True))
    assert acc.shape == (n, 3) and acc.dtype == np.float32
    assert_matches_oracle(acc, oracle_forces(pos, mass, EPS2),
                          f"acc(kernel n={n} {bi}x{bj})")


@pytest.mark.parametrize("bi,bj", [(16, 32), (64, 16)])
@pytest.mark.parametrize("ni,nj", [(64, 100), (100, 64), (1, 300),
                                   (257, 33), (128, 128)])
def test_rect_kernel_matches_oracle(ni, nj, bi, bj):
    """Disjoint i- and j-sets of different sizes (the mesh ring's local
    sweep)."""
    pos_i, _, _ = make_small_system(ni, seed=ni + 1)
    pos_j, _, mass_j = make_small_system(nj, seed=nj + 2)
    acc = np.asarray(rect_forces_pallas(
        jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(mass_j), EPS2,
        block_i=bi, block_j=bj, interpret=True))
    assert acc.shape == (ni, 3)
    assert_matches_oracle(acc, _rect_oracle(pos_i, pos_j, mass_j, EPS2),
                          f"acc(rect {ni}x{nj})")


@pytest.mark.parametrize("extra", [1, 31, 64])
def test_zero_mass_ghosts_are_inert(extra):
    """Appending zero-mass bodies changes no force on the real ones — the
    property the wrapper's padding relies on."""
    n = 96
    pos, _, mass = make_small_system(n, seed=5)
    r = np.random.default_rng(extra)
    ghosts = r.uniform(-1e5, 1e5, size=(extra, 3)).astype(np.float32)
    pos_g = np.concatenate([pos, ghosts])
    mass_g = np.concatenate([mass, np.zeros(extra, np.float32)])
    base = np.asarray(forces_pallas(jnp.asarray(pos), jnp.asarray(mass),
                                    EPS2, block_i=32, block_j=32,
                                    interpret=True))
    padded = np.asarray(forces_pallas(jnp.asarray(pos_g),
                                      jnp.asarray(mass_g), EPS2,
                                      block_i=32, block_j=32,
                                      interpret=True))
    np.testing.assert_allclose(padded[:n], base, rtol=1e-6, atol=1e-6)


def test_self_pair_in_rect_vanishes():
    """The same body on both sides contributes nothing (r = 0 under
    softening), so a rectangle whose j-set contains the i-set needs no
    mask."""
    pos, _, mass = make_small_system(40, seed=6)
    both = np.asarray(rect_forces_pallas(
        jnp.asarray(pos[:8]), jnp.asarray(pos), jnp.asarray(mass), EPS2,
        block_i=8, block_j=16, interpret=True))
    ref = oracle_forces(pos, mass, EPS2)[:8]
    assert_matches_oracle(both, ref, "acc(rect with self-pairs)")


@pytest.mark.parametrize("n", [64, 300, 1000])
def test_kernel_cross_checks_xla(n):
    """Two independent device implementations agree tightly."""
    pos, _, mass = make_small_system(n, seed=12)
    p, m = jnp.asarray(pos), jnp.asarray(mass)
    a_k = np.asarray(forces_pallas(p, m, EPS2, block_i=32, block_j=64,
                                   interpret=True))
    a_c = np.asarray(forces_chunked(p, m, EPS2, chunk=128))
    a_n = np.asarray(forces_nxn(p, m, EPS2))
    for other in (a_c, a_n):
        assert relative_mismatch(a_k, other, 1e-3, 1e-2).mean() == 0.0


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16, jnp.int32])
def test_rejects_non_f32(dtype):
    pos, _, mass = make_small_system(16, seed=1)
    with pytest.raises(ValueError, match="float32-only"):
        forces_pallas(jnp.asarray(pos).astype(dtype), jnp.asarray(mass),
                      EPS2, interpret=True)


@pytest.mark.parametrize("name", ["block_i", "block_j"])
@pytest.mark.parametrize("bad", [0, -8, 3, 48, 100])
def test_rejects_non_power_of_two_blocks(name, bad):
    pos, _, mass = make_small_system(16, seed=1)
    with pytest.raises(ValueError, match=f"{name} must be a power of two"):
        forces_pallas(jnp.asarray(pos), jnp.asarray(mass), EPS2,
                      interpret=True, **{name: bad})


@pytest.mark.parametrize("fn", ["square", "rect"])
def test_refuses_non_gpu_backend_without_interpret(fn):
    """No silent interpreter: off the GPU the kernel raises unless the
    caller asked for interpret mode."""
    assert jax.default_backend() != "gpu"
    pos, _, mass = make_small_system(16, seed=1)
    p, m = jnp.asarray(pos), jnp.asarray(mass)
    with pytest.raises(RuntimeError, match="GPU only"):
        if fn == "square":
            forces_pallas(p, m, EPS2)
        else:
            rect_forces_pallas(p, p, m, EPS2)


def test_defaults_are_powers_of_two():
    for b in (DEFAULT_BLOCK_I, DEFAULT_BLOCK_J):
        assert b > 0 and b & (b - 1) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8191, 8192])
def test_compiled_kernel_matches_oracle(n):
    """The kernel as compiled for the card, at the reference's N."""
    pos, _, mass = make_small_system(n, seed=3)
    acc = np.asarray(forces_pallas(jnp.asarray(pos), jnp.asarray(mass),
                                   EPS2))
    assert relative_mismatch(acc, oracle_forces(pos, mass, EPS2), 0.01,
                             1e-6).mean() == 0.0
