"""Tiled all-pairs force kernel in Pallas, compiled through Triton for the
GPU — the analog of the reference's shared-memory tiled CUDA kernel
(``kernel.cu:80-130``).

Mapping:

- one thread per body accumulating in registers (``kernel.cu:96-114``)  ==>
  one program holds ``block_i`` bodies and walks every j-tile of
  ``block_j`` bodies with a ``lax.fori_loop`` over ``pl.ds`` loads; the
  (block_i, block_j) partial sums stay in registers for the whole sweep
  and are reduced over j once, after the loop.
- the block's cooperative shared-memory staging + ``__syncthreads``
  (``kernel.cu:99-113``)  ==>  Triton's software pipeline over the j loop
  (``num_stages``).
- ``float4 {x, y, z, w=m}`` bodies (``kernel.cu:80``)  ==>  the same four
  fields laid out as an SoA ``(4, N_pad)`` array, so every load is a
  contiguous power-of-two row slice.
- the ``tid >= N`` guards (``kernel.cu:90-92``)  ==>  zero-mass ghost
  padding: a ghost contributes exactly zero force, and the self-pair
  vanishes through r = 0 under softening (``kernel.cu:17-27``).
- ``1/sqrtf(distSqrt^3)`` (``kernel.cu:20``)  ==>  ``lax.rsqrt``.

Precision is the exact float32 class: float32 state, float32 pair terms,
plain float32 sums; no matrix units (TF32 would leave the class).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import DEFAULT_BLOCK_I, DEFAULT_BLOCK_J
from ..models.state import round_up
from ..utils.device import kernel_available

# Chosen with the default blocks (config.py) by a block sweep on an H100
# (PERF.md "Kernel block sweep").
NUM_WARPS = 8
NUM_STAGES = 3


def _force_kernel(pos_i_ref, pos_j_ref, ax_ref, ay_ref, az_ref, *, eps2,
                  block_i, block_j, n_j_tiles):
    xi = pos_i_ref[0, :][:, None]                  # (BI, 1)
    yi = pos_i_ref[1, :][:, None]
    zi = pos_i_ref[2, :][:, None]

    def body(t, acc):
        ax, ay, az = acc
        cols = pl.ds(t * block_j, block_j)
        dx = pos_j_ref[0, cols][None, :] - xi       # (BI, BJ)
        dy = pos_j_ref[1, cols][None, :] - yi
        dz = pos_j_ref[2, cols][None, :] - zi
        d2 = dx * dx + dy * dy + dz * dz + eps2
        f = pos_j_ref[3, cols][None, :] * jax.lax.rsqrt(d2 * d2 * d2)
        return ax + f * dx, ay + f * dy, az + f * dz

    zero = jnp.zeros((block_i, block_j), jnp.float32)
    ax, ay, az = jax.lax.fori_loop(0, n_j_tiles, body, (zero, zero, zero))
    ax_ref[:] = jnp.sum(ax, axis=1)
    ay_ref[:] = jnp.sum(ay, axis=1)
    az_ref[:] = jnp.sum(az, axis=1)


@functools.partial(
    jax.jit, static_argnames=("eps2", "block_i", "block_j", "interpret"))
def _sweep(soa_i, soa_j, eps2, block_i, block_j, interpret):
    """(4, Ni_pad) i-bodies x (4, Nj_pad) j-bodies -> (Ni_pad, 3)."""
    ni_pad, nj_pad = soa_i.shape[1], soa_j.shape[1]
    kernel = functools.partial(
        _force_kernel, eps2=eps2, block_i=block_i, block_j=block_j,
        n_j_tiles=nj_pad // block_j)
    out_spec = pl.BlockSpec((block_i,), lambda i: (i,))
    ax, ay, az = pl.pallas_call(
        kernel,
        grid=(ni_pad // block_i,),
        in_specs=[pl.BlockSpec((4, block_i), lambda i: (0, i)),
                  pl.BlockSpec((4, nj_pad), lambda i: (0, 0))],
        out_specs=[out_spec, out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((ni_pad,), jnp.float32)] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=20 * ni_pad * nj_pad,
            bytes_accessed=(4 * ni_pad + 4 * nj_pad * (ni_pad // block_i)
                            + 3 * ni_pad) * 4,
            transcendentals=ni_pad * nj_pad),
        interpret=interpret,
        name="nbody_forces",
    )(soa_i, soa_j)
    return jnp.stack([ax, ay, az], axis=1)


def _soa(pos, mass, n_pad):
    """(N,3),(N,) -> (4, n_pad) rows x/y/z/m, zero-mass ghosts appended."""
    soa = jnp.concatenate([pos.T, mass[None, :]], axis=0)
    return jnp.pad(soa, ((0, 0), (0, n_pad - pos.shape[0])))


def _check(pos, block_i, block_j, interpret):
    if pos.dtype != jnp.float32:
        raise ValueError(
            f"the tiled force kernel is float32-only (got {pos.dtype}); "
            "use impl='xla' for float64/bfloat16 state")
    for name, b in (("block_i", block_i), ("block_j", block_j)):
        if b < 1 or b & (b - 1):
            raise ValueError(f"{name} must be a power of two, got {b}")
    if not interpret and not kernel_available():
        raise RuntimeError(
            f"the tiled force kernel compiles for the GPU only (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it in "
            "the Pallas interpreter, or use impl='xla'")


def forces_pallas(pos: jax.Array, mass: jax.Array, eps2: float,
                  block_i: int = DEFAULT_BLOCK_I,
                  block_j: int = DEFAULT_BLOCK_J,
                  interpret: bool = False) -> jax.Array:
    """Softened all-pairs accelerations via the tiled kernel.
    (N,3) f32, (N,) f32 -> (N,3) f32."""
    return rect_forces_pallas(pos, pos, mass, eps2, block_i=block_i,
                              block_j=block_j, interpret=interpret)


def rect_forces_pallas(pos_i: jax.Array, pos_j: jax.Array,
                       mass_j: jax.Array, eps2: float,
                       block_i: int = DEFAULT_BLOCK_I,
                       block_j: int = DEFAULT_BLOCK_J,
                       interpret: bool = False) -> jax.Array:
    """Forces of body set j on body set i — the rectangular block of the
    interaction matrix, and the local sweep of each shard in the mesh ring
    (``parallel/ring.py``).  Either set may hold ghosts or the other set's
    bodies: no pair is masked, since self-pairs vanish through r = 0.
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3)."""
    _check(pos_i, block_i, block_j, interpret)
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    soa_i = _soa(pos_i, jnp.zeros((ni,), jnp.float32), round_up(ni, block_i))
    soa_j = _soa(pos_j, mass_j.astype(jnp.float32), round_up(nj, block_j))
    acc = _sweep(soa_i, soa_j, float(eps2), block_i, block_j,
                 bool(interpret))
    return acc[:ni]
