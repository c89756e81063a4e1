"""Jitted simulation step and multi-step drivers.

The reference's host loop launches one kernel per step with a
``cudaDeviceSynchronize`` barrier every iteration (``main.cpp:142-160``,
``kernel.cu:644``) — two host<->device boundary crossings per step.  The
rebuild compiles the *whole run* into one XLA program: a single
``step`` is a jitted function (force + fused integration, so pos/vel/acc never
leave device memory), and ``run_steps`` wraps it in ``lax.fori_loop`` — zero host
round-trips until the loop finishes.  ``run_trajectory`` is the ``lax.scan``
variant that additionally captures snapshots on-device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax

from ..config import SimConfig
from ..models.integrators import (KDK_WEIGHTS, kdk_drift, kdk_kick,
                                  reference_update)
from ..models.state import SimState
from .forces import compute_forces, resolve_impl


def step(state: SimState, cfg: SimConfig, impl: "str | None" = None) -> SimState:
    """One simulation step. Matches the semantics of one ``simulate`` call
    (kernel.cu:628-645): forces from current positions, then the fused
    half-kick + drift update (or KDK when configured)."""
    impl = impl or resolve_impl(cfg)
    if cfg.integrator == "reference":
        acc = compute_forces(state.pos, state.mass, cfg, impl=impl)
        pos, vel = reference_update(state.pos, state.vel, acc, cfg.dt)
        return SimState(pos=pos, vel=vel, acc=acc, mass=state.mass)
    weights = KDK_WEIGHTS.get(cfg.integrator)
    if weights is not None:
        # KDK-composed schemes (kdk = one sub-step, yoshida4 = three): each
        # sub-step is kick-drift-kick over weight*dt, chaining a(x) through
        # state.acc (seed a(x_0) via `prime_kdk`).
        pos, vel, acc = state.pos, state.vel, state.acc
        for w in weights:
            wdt = w * cfg.dt
            vel_half = kdk_kick(vel, acc, wdt)
            pos = kdk_drift(pos, vel_half, wdt)
            acc = compute_forces(pos, state.mass, cfg, impl=impl)
            vel = kdk_kick(vel_half, acc, wdt)
        return SimState(pos=pos, vel=vel, acc=acc, mass=state.mass)
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def prime_kdk(state: SimState, cfg: SimConfig,
              impl: "str | None" = None) -> SimState:
    """Seed state.acc = a(x_0) so the KDK integrator's first half-kick is
    consistent."""
    impl = impl or resolve_impl(cfg)
    acc = compute_forces(state.pos, state.mass, cfg, impl=impl)
    return state._replace(acc=acc)


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "impl"))
def run_steps(state: SimState, cfg: SimConfig, n_steps: int,
              impl: "str | None" = None) -> SimState:
    """Run n_steps inside one compiled fori_loop (the benchmark path)."""
    return jax.lax.fori_loop(
        0, n_steps, lambda _, s: step(s, cfg, impl=impl), state)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_steps", "snap_every", "impl", "with_vel"))
def run_trajectory(
        state: SimState, cfg: SimConfig, n_steps: int,
        snap_every: int = 1, impl: "str | None" = None,
        with_vel: bool = False) -> Tuple[SimState, jax.Array]:
    """Run n_steps, capturing positions every ``snap_every`` steps on-device.

    Returns (final_state, snapshots (n_steps//snap_every, N, 3)).  If
    snap_every does not divide n_steps, the remainder steps still run after
    the last snapshot (the final state reflects all n_steps).

    ``with_vel=True`` additionally captures velocities (doubling the
    snapshot transfer) and returns ``(final_state, snapshots,
    vel_snapshots)`` — this is what gives saved trajectories an energy /
    virial story (``analysis.analyze_trajectory``), which positions alone
    cannot carry.
    """
    def outer(s, _):
        s = jax.lax.fori_loop(
            0, snap_every, lambda _, st: step(st, cfg, impl=impl), s)
        return s, ((s.pos, s.vel) if with_vel else s.pos)
    n_snaps = n_steps // snap_every
    final, snaps = jax.lax.scan(outer, state, None, length=n_snaps)
    rem = n_steps - n_snaps * snap_every
    if rem:
        final = jax.lax.fori_loop(
            0, rem, lambda _, st: step(st, cfg, impl=impl), final)
    if with_vel:
        return (final,) + snaps
    return final, snaps


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_steps", "frame_every", "impl",
                              "packed"))
def run_trajectory_frames(
        state: SimState, cfg: SimConfig, n_steps: int,
        frame_every: int = 1,
        impl: "str | None" = None,
        packed: bool = False,
        view: "tuple | None" = None) -> Tuple[SimState, jax.Array]:
    """Run n_steps with RENDERED frames captured on device inside the scan.

    The interactive-rate path: the reference renders
    every step with zero compute<->render copies via CUDA-GL interop
    (main.cpp:118-133, kernel.cu:477-481); here the rasterizer runs inside
    the compiled loop so frames batch through the device->host link in ONE
    transfer per chunk instead of one round-trip per frame.

    Returns (final_state, frames): (F, H, W, 3) uint8 RGB, or with
    ``packed=True`` an (F, H, W) uint8 weight map (1 byte/pixel — the
    bandwidth-lean wire format; ``viz.raster.colorize`` reproduces the RGB
    pixels exactly on the host).

    ``view``: optional ``(max_view, cu, cv)`` TRACED scalars overriding
    the config's fixed camera — the live viewer's zoom/pan.  Passed as
    plain floats they trace as f32 scalars, so per-chunk view changes
    recompile nothing.
    """
    from ..viz.raster import render_frame, render_weights

    render = render_weights if packed else render_frame
    mv, cu, cv = view if view is not None else (cfg.max_view, 0.0, 0.0)

    def outer(s, _):
        s = jax.lax.fori_loop(
            0, frame_every, lambda _, st: step(st, cfg, impl=impl), s)
        frame = render(
            s.pos, s.mass, cfg.min_mass, cfg.max_mass, mv,
            cfg.viz_width, cfg.viz_height, 2, cu, cv)
        return s, frame
    n_frames = n_steps // frame_every
    final, frames = jax.lax.scan(outer, state, None, length=n_frames)
    rem = n_steps - n_frames * frame_every
    if rem:
        final = jax.lax.fori_loop(
            0, rem, lambda _, st: step(st, cfg, impl=impl), final)
    return final, frames
