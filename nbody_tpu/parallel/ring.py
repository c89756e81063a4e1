"""Multi-device ring all-pairs sweep — the mesh lift of the reference's
intra-GPU tile sweep.

The reference streams the full position set through shared memory in
block-sized tiles (``kernel.cu:96-114``); here bodies are sharded across a
1-D device mesh and the *j-side* (positions + masses) rotates around the
ring with ``lax.ppermute`` so every device's i-shard meets every position in
P hops — structurally ring attention applied to the interaction matrix
(SURVEY.md sections 2.3 and 5).  An ``all_gather`` variant (gather the whole
position set, then one local sweep) is provided as the Ulysses-style
alternative.  XLA hands both collectives to NCCL on the GPU.

Everything (ring sweep + fused integration + the multi-step loop) lives
inside one ``shard_map``-over-``jit`` program: zero host round-trips.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SimConfig
from ..models.integrators import (KDK_WEIGHTS, kdk_drift, kdk_kick,
                                  reference_update)
from ..models.state import SimState, pad_state_to, round_up, unpad_state
from ..ops.forces import resolve_impl
from ..ops.forces_xla import rect_forces
from .mesh import SHARD_AXIS


def _local_rect_forces(pos_i, pos_j, mass_j, cfg: SimConfig, impl: str):
    """Per-device (i-shard x j-tile) force block: the tiled kernel for
    impl='pallas', XLA's chunked rectangle otherwise."""
    if impl == "pallas":
        from ..ops import forces_pallas
        return forces_pallas.rect_forces_pallas(
            pos_i, pos_j, mass_j, cfg.eps2,
            block_i=cfg.block_i, block_j=cfg.block_j)
    return rect_forces(pos_i, pos_j, mass_j, cfg.eps2, chunk=cfg.chunk)


def _resolve_local_impl(cfg: SimConfig, impl: Optional[str]) -> str:
    """Resolve None/'auto' for the sharded entry points through the one
    device-routing rule (``ops.forces.resolve_impl``)."""
    if impl is not None and impl != "auto":
        return impl
    return resolve_impl(cfg.replace(impl="auto"), sharded=True)


def ring_forces_local(pos_l, mass_l, cfg: SimConfig, impl: str,
                      axis: str = SHARD_AXIS):
    """Ring sweep, written per-shard (call inside shard_map): accumulate
    forces from P rotating j-tiles, starting with the device's own
    shard."""
    p = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % p) for i in range(p)]

    acc0 = _local_rect_forces(pos_l, pos_l, mass_l, cfg, impl)

    def body(step, carry):
        acc, pos_j, mass_j = carry
        # Rotate the j-tile to the next device, then sweep it.  XLA's async
        # collective-permute scheduling provides the compute/comm overlap
        # across iterations.
        pos_j = jax.lax.ppermute(pos_j, axis, perm)
        mass_j = jax.lax.ppermute(mass_j, axis, perm)
        acc = acc + _local_rect_forces(pos_l, pos_j, mass_j, cfg, impl)
        return acc, pos_j, mass_j

    acc, _, _ = jax.lax.fori_loop(0, p - 1, body, (acc0, pos_l, mass_l))
    return acc


def allgather_forces_local(pos_l, mass_l, cfg: SimConfig, impl: str,
                           axis: str = SHARD_AXIS):
    """Ulysses-style alternative: all-gather the full j-side once, then one
    local rectangular sweep.  O(N) memory per device."""
    pos_all = jax.lax.all_gather(pos_l, axis, tiled=True)
    mass_all = jax.lax.all_gather(mass_l, axis, tiled=True)
    return _local_rect_forces(pos_l, pos_all, mass_all, cfg, impl)


_LOCAL_FORCES = {"ring": ring_forces_local,
                 "allgather": allgather_forces_local}


def _one_step_local(mass_l, cfg: SimConfig, impl: str, comm: str,
                    axis: str):
    """Build the per-shard single-step update ``(pos, vel, acc) ->
    (pos, vel, acc)`` for the configured comm tier + integrator — shared
    by the plain run loop and the in-loop frame loop."""
    force = _LOCAL_FORCES[comm]

    weights = KDK_WEIGHTS.get(cfg.integrator)
    if weights is not None:
        # KDK-composed schemes (kdk/yoshida4), same as ops.step.step: the
        # first half-kick uses the acceleration carried in state.acc
        # (callers must prime it with a(x_0); Simulation.__init__ does via
        # prime_kdk).  The sub-step loop unrolls at trace time.
        def one_step(carry):
            pos, vel, acc = carry
            for w in weights:
                wdt = w * cfg.dt
                vel_half = kdk_kick(vel, acc, wdt)
                pos = kdk_drift(pos, vel_half, wdt)
                acc = force(pos, mass_l, cfg, impl, axis)
                vel = kdk_kick(vel_half, acc, wdt)
            return pos, vel, acc
    elif cfg.integrator == "reference":
        def one_step(carry):
            pos, vel, acc = carry
            new_acc = force(pos, mass_l, cfg, impl, axis)
            new_pos, new_vel = reference_update(pos, vel, new_acc, cfg.dt)
            return new_pos, new_vel, new_acc
    else:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    return one_step


def _sharded_run_local(pos_l, vel_l, acc_l, mass_l, *, cfg: SimConfig,
                       n_steps: int, impl: str, comm: str, axis: str):
    one_step = _one_step_local(mass_l, cfg, impl, comm, axis)
    pos, vel, acc = jax.lax.fori_loop(
        0, n_steps, lambda _, c: one_step(c), (pos_l, vel_l, acc_l))
    return pos, vel, acc


def shard_padding(cfg: SimConfig, n_devices: int) -> int:
    """Padded N: divisible by P and, per shard, by the force-block sizes."""
    per_shard_multiple = max(cfg.block_i, cfg.block_j, 8)
    return round_up(cfg.n_bodies, n_devices * per_shard_multiple)


def run_steps_sharded(state: SimState, cfg: SimConfig, mesh: Mesh,
                      n_steps: int, impl: Optional[str] = None,
                      comm: str = "ring", axis: str = SHARD_AXIS) -> SimState:
    """Run n_steps of the sharded simulation on a 1-D mesh.

    State is padded with zero-mass ghosts to a shard-able size, sharded over
    the mesh, advanced entirely on-device, and unpadded on return (still
    sharded; pull with np.asarray when needed).
    """
    if comm not in _LOCAL_FORCES:
        raise ValueError(
            f"comm must be one of {sorted(_LOCAL_FORCES)}, got {comm!r}")
    local_impl = _resolve_local_impl(cfg, impl)
    n_real = state.n
    p = mesh.shape[axis]
    state = pad_state_to(state, shard_padding(cfg, p))

    sharded = _sharded_run_program(mesh, axis, cfg, n_steps, local_impl,
                                   comm)
    pos, vel, acc = sharded(state.pos, state.vel, state.acc, state.mass)
    out = SimState(pos=pos, vel=vel, acc=acc, mass=state.mass)
    return unpad_state(out, n_real)


@functools.lru_cache(maxsize=32)
def _sharded_run_program(mesh: Mesh, axis: str, cfg: SimConfig,
                         n_steps: int, impl: str, comm: str):
    """Compile-once jitted shard_map chunk program.  Cached: the run
    loop calls per CHUNK, and a fresh ``jax.jit`` wrapper per call would
    retrace at every chunk boundary."""
    fn = functools.partial(
        _sharded_run_local, cfg=cfg, n_steps=n_steps, impl=impl,
        comm=comm, axis=axis)
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis)),
            # pallas_call's out_shape carries no varying-mesh-axes
            # annotation; skip the vma check rather than threading vma
            # through every kernel out_shape.
            check_vma=False,
        ))


def prime_kdk_sharded(state: SimState, cfg: SimConfig, mesh: Mesh,
                      impl: Optional[str] = None, comm: str = "ring",
                      axis: str = SHARD_AXIS) -> SimState:
    """Seed ``state.acc = a(x_0)`` ON THE MESH — the sharded analog of
    ``ops.step.prime_kdk``, which would gather the (born-sharded) state
    onto one device and run a full single-device N² evaluation."""
    p = mesh.shape[axis]
    local_impl = _resolve_local_impl(cfg, impl)
    n_real = state.n
    state = pad_state_to(state, shard_padding(cfg, p))

    def prime_local(pos_l, mass_l):
        return _LOCAL_FORCES[comm](pos_l, mass_l, cfg, local_impl, axis)

    sharded = jax.jit(
        jax.shard_map(
            prime_local, mesh=mesh, in_specs=(P(axis), P(axis)),
            out_specs=P(axis), check_vma=False))
    acc = sharded(state.pos, state.mass)
    return unpad_state(state._replace(acc=acc), n_real)


def _sharded_frames_local(pos_l, vel_l, acc_l, mass_l, view_arr, *,
                          cfg: SimConfig, n_steps: int, frame_every: int,
                          impl: str, comm: str, axis: str):
    """Per-shard run loop with in-loop rendered frames: each device
    rasterizes its LOCAL shard to a packed (H, W) weight map inside the
    compiled loop and the maps max-combine across the mesh (``pmax`` —
    the same brightest-point splat rule the rasterizer uses per pixel,
    so the combined frame is pixel-identical to rendering the gathered
    state).  Zero-mass ghosts never draw, so padding is invisible.

    ``view_arr``: (3,) f32 camera ``(max_view, cu, cv)`` — a TRACED
    operand like the single-device path's, so live-viewer zoom/pan
    changes recompile nothing."""
    from ..viz.raster import render_weights
    one_step = _one_step_local(mass_l, cfg, impl, comm, axis)
    mv, cu, cv = view_arr[0], view_arr[1], view_arr[2]

    def outer(carry, _):
        carry = jax.lax.fori_loop(
            0, frame_every, lambda _, c: one_step(c), carry)
        pos, _, _ = carry
        w8 = render_weights(pos, mass_l, cfg.min_mass, cfg.max_mass, mv,
                            cfg.viz_width, cfg.viz_height, 2, cu, cv)
        # uint8 rides the collective as int32 (max-combine; cast back).
        w8 = jax.lax.pmax(w8.astype(jnp.int32), axis).astype(jnp.uint8)
        return carry, w8

    n_frames = n_steps // frame_every
    carry, frames = jax.lax.scan(
        outer, (pos_l, vel_l, acc_l), None, length=n_frames)
    rem = n_steps - n_frames * frame_every
    if rem:
        carry = jax.lax.fori_loop(
            0, rem, lambda _, c: one_step(c), carry)
    pos, vel, acc = carry
    return pos, vel, acc, frames


def run_trajectory_frames_sharded(
        state: SimState, cfg: SimConfig, mesh: Mesh, n_steps: int,
        frame_every: int = 1, impl: Optional[str] = None,
        comm: str = "ring", view: "tuple | None" = None,
        axis: str = SHARD_AXIS):
    """``ops.step.run_trajectory_frames`` on a mesh: the whole chunk —
    ring sweeps, integration, AND rasterization — runs inside one
    ``jit(shard_map(...))`` program; frames batch through the
    device->host link in one transfer per chunk exactly like the
    single-device path.

    Returns ``(final SimState, frames (F, H, W) uint8 packed weight
    maps)`` — feed ``viz.raster.colorize`` for RGB.
    """
    n_real = state.n
    p = mesh.shape[axis]
    state = pad_state_to(state, shard_padding(cfg, p))
    local_impl = _resolve_local_impl(cfg, impl)
    mv, cu, cv = view if view is not None else (cfg.max_view, 0.0, 0.0)

    sharded = _sharded_frames_program(mesh, axis, cfg, n_steps,
                                      frame_every, local_impl, comm)
    view_arr = jnp.asarray([mv, cu, cv], jnp.float32)
    pos, vel, acc, frames = sharded(state.pos, state.vel, state.acc,
                                    state.mass, view_arr)
    out = SimState(pos=pos, vel=vel, acc=acc, mass=state.mass)
    return unpad_state(out, n_real), frames


@functools.lru_cache(maxsize=32)
def _sharded_frames_program(mesh: Mesh, axis: str, cfg: SimConfig,
                            n_steps: int, frame_every: int, impl: str,
                            comm: str):
    """Compile-once jitted shard_map frames program (cached for the same
    per-chunk reasons as ``_sharded_run_program``; the camera rides as a
    traced (3,) operand so it is NOT part of the key)."""
    fn = functools.partial(
        _sharded_frames_local, cfg=cfg, n_steps=n_steps,
        frame_every=frame_every, impl=impl, comm=comm, axis=axis)
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
            # frames are replicated after the pmax combine.
            out_specs=(P(axis), P(axis), P(axis), P()),
            check_vma=False,
        ))
