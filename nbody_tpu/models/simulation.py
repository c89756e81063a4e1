"""High-level simulation driver.

The runtime orchestration layer — the role of the reference's
``simulationLoop*`` family (``main.cpp:20-160``) plus everything the
reference lacks around it (SURVEY.md section 5): structured logging,
checkpoint/resume, NaN watchdog, energy accounting, and headless frame
streaming.  The hot path stays fully compiled: steps run in jitted chunks
(``lax.fori_loop``), and the host only intervenes at reporting cadence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import numpy as np

from ..config import SimConfig
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.logger import RunLogger
from ..models.energy import energy_f64
from ..models.init import init_state
from ..models.state import SimState
from ..ops.forces import resolve_impl
from ..ops.step import prime_kdk, run_steps
from ..utils.timing import StepTimer, sync


@dataclasses.dataclass
class SimResult:
    state: SimState
    steps_run: int
    ms_per_step: float
    ginter_per_s: float
    energy_initial: Optional[float] = None
    energy_final: Optional[float] = None

    @property
    def energy_drift(self) -> Optional[float]:
        if self.energy_initial is None or self.energy_final is None:
            return None
        scale = abs(self.energy_initial) or 1.0
        return abs(self.energy_final - self.energy_initial) / scale


def auto_log_every(cfg: SimConfig, n_steps: int) -> int:
    """Default progress-log cadence (``log_every=None``).

    Every chunk boundary syncs the device (the timer and NaN watchdog
    need real state) and leaves it idle while the host logs, so a fixed
    small cadence at small N costs throughput.  Size the cadence so one
    chunk is >= ~0.5 s of estimated device work at a nominal 300
    GInter/s (underestimating the rate only makes chunks longer), and cap
    the line count at ~50 per run.

    Prefer a cadence that DIVIDES n_steps: compiled programs embed the
    chunk length, so a ragged final chunk is a fresh compile that
    pollutes the run's summary rate.  The nearest divisor is used when it keeps chunks within 4x
    of the target; pathological step counts (primes) fall back to the
    target and eat the one extra compile."""
    per_step_s = cfg.interactions_per_step / 300e9
    target = max(1, int(0.5 / per_step_s), n_steps // 50)
    if n_steps <= target:
        return target
    above = None      # smallest divisor >= target
    below = None      # largest divisor in [target/2, target)
    d = 1
    while d * d <= n_steps:
        if n_steps % d == 0:
            for c in (d, n_steps // d):
                if c >= target:
                    if above is None or c < above:
                        above = c
                elif 2 * c >= target and (below is None or c > below):
                    below = c
        d += 1
    if above is not None and above <= 4 * target and above < n_steps:
        return above
    if below is not None:
        # Slightly shorter chunks beat a ragged tail: one program either
        # way the chunks stay near the duration target.
        return below
    return target


class Simulation:
    """Owns a state + config; runs chunks of compiled steps with host-side
    services (logging / checkpoints / viz / watchdog) between chunks."""

    def __init__(self, cfg: SimConfig, state=None,
                 logger: Optional[RunLogger] = None,
                 mesh=None, comm: str = "ring"):
        self.cfg = cfg
        self.logger = logger or RunLogger(quiet=True)
        self.mesh = mesh
        self.comm = comm
        self.impl = resolve_impl(cfg, sharded=mesh is not None)
        if state is None:
            # On a mesh whose padded N equals N (the common case), the
            # state is BORN sharded: generated via jit out_shardings so no
            # single-device copy of the whole state is ever made.
            sharded = None
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec
                from ..parallel.mesh import SHARD_AXIS
                from ..parallel.ring import shard_padding
                if shard_padding(cfg, mesh.devices.size) == cfg.n_bodies:
                    sharded = NamedSharding(mesh, PartitionSpec(SHARD_AXIS))
            state = init_state(cfg, sharding=sharded)
        self.state = state
        if cfg.integrator != "reference":
            if mesh is not None:
                # Mesh runs prime ON the mesh: the single-device
                # prime_kdk would gather the sharded state to one device.
                from ..parallel.ring import prime_kdk_sharded
                self.state = prime_kdk_sharded(
                    self.state, cfg, mesh, impl=self.impl, comm=comm)
            else:
                self.state = prime_kdk(self.state, cfg, impl=self.impl)
        self.step_count = 0

    @classmethod
    def resume(cls, path: str, cfg: Optional[SimConfig] = None,
               logger: Optional[RunLogger] = None,
               overrides: Optional[dict] = None,
               mesh=None, comm: str = "ring") -> "Simulation":
        """Resume from a checkpoint.

        When the checkpoint embeds a config and ``overrides`` is given
        (the CLI passes only the flags the user explicitly set), the saved
        config is the base and only those fields are overridden — resuming
        without re-passing the original --dt/--eps2/--n keeps the original
        physics.  ``n_bodies`` is always reconciled with the restored state
        size (the GInter/s timer and shard padding depend on it)."""
        from ..io.checkpoint import load_checkpoint_meta
        step_count, saved_cfg, n_saved = load_checkpoint_meta(path)
        if saved_cfg is not None and overrides is not None:
            cfg = saved_cfg.replace(**overrides)
        else:
            cfg = cfg or saved_cfg
        if cfg is None:
            raise ValueError(
                f"checkpoint {path} has no embedded config; pass cfg=")
        if cfg.n_bodies != n_saved:
            import warnings
            warnings.warn(
                f"checkpoint {path} holds {n_saved} bodies but config says "
                f"n_bodies={cfg.n_bodies}; using the checkpoint's {n_saved}")
            cfg = cfg.replace(n_bodies=n_saved)
        state, _, _ = load_checkpoint(path)
        sim = cls(cfg, state=state, logger=logger, mesh=mesh, comm=comm)
        sim.step_count = step_count
        return sim

    def _total_energy(self) -> float:
        """Total energy for ``track_energy``.  Host f64 below the host
        wall; past it a MESH run computes on the mesh as bounded
        per-device programs (``parallel/energy.py`` — no gather) while
        single-device runs take ``energy_f64``'s own bounded
        delegation."""
        from ..parallel import energy as _penergy
        if (self.mesh is not None
                and self.cfg.n_bodies > _penergy.MAX_HOST_ENERGY_N):
            return _penergy.total_energy_sharded(
                self.state, self.cfg.eps2, self.mesh)
        return energy_f64(self.state, self.cfg.eps2)

    def _run_chunk(self, n: int) -> None:
        if self.mesh is not None:
            from ..parallel.ring import run_steps_sharded
            self.state = run_steps_sharded(
                self.state, self.cfg, self.mesh, n, impl=self.impl,
                comm=self.comm)
        else:
            self.state = run_steps(self.state, self.cfg, n, impl=self.impl)

    def run(self, n_steps: Optional[int] = None,
            log_every: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0,
            frame_streamer=None,
            track_energy: bool = False,
            nan_watchdog: bool = True,
            sort_every: int = 0) -> SimResult:
        n_steps = n_steps if n_steps is not None else self.cfg.steps
        cfg = self.cfg
        if log_every is None:
            log_every = auto_log_every(cfg, n_steps)
        timer = StepTimer(n_bodies=cfg.n_bodies)

        e0 = self._total_energy() if track_energy else None
        self.logger.banner(
            f"== nbody_tpu: N={cfg.n_bodies} steps={n_steps} "
            f"impl={self.impl} integrator={cfg.integrator} "
            f"dt={cfg.dt} eps2={cfg.eps2} "
            f"backend={jax.default_backend()} ==")

        # Chunk size: log cadence and checkpoint cadence bound how long the
        # device runs uninterrupted.  Frames do NOT bound the chunk: they
        # render on device INSIDE the compiled chunk (run_trajectory_frames
        # single-device; run_trajectory_frames_sharded on a mesh, local
        # shards max-combined with pmax) and batch through the host link
        # in one transfer instead of one round-trip per frame.  Only cap
        # the chunk so the frame batch stays within a memory budget.
        viz = frame_streamer is not None and cfg.viz_every > 0
        cadences = [log_every if log_every > 0 else n_steps]
        if viz:
            # Packed maps are 1 byte/pixel; keep chunks small enough that
            # frame transfers overlap the NEXT chunk's compute (only the
            # final chunk's transfer is serial).
            frame_bytes = cfg.viz_width * cfg.viz_height
            max_frames = max(1, min(24, (32 << 20) // frame_bytes))
            cadences.append(cfg.viz_every * max_frames)
        if checkpoint_every > 0:
            cadences.append(checkpoint_every)
        if sort_every > 0:
            cadences.append(sort_every)
        chunk = max(1, min(cadences))
        if viz and chunk % cfg.viz_every:
            # Frame batches count todo // viz_every frames; keep chunks
            # frame-aligned so none are dropped.
            chunk = max(cfg.viz_every, chunk - chunk % cfg.viz_every)
        # The modulo triggers below (checkpoint/sort) fire at
        # done % cadence == 0; end chunks exactly at those boundaries.
        boundary_cadences = [c for c in (checkpoint_every, sort_every)
                             if c > 0]

        if sort_every > 0:
            # Initial Z-order sort (improves any spatially-blocked path).
            # Body identity is permuted — gravity is
            # permutation-equivariant.
            from .ordering import morton_sort_state
            self.state, _ = morton_sort_state(
                self.state, -cfg.max_pos, cfg.max_pos)

        done = 0
        frame_idx = 0
        first_chunk_s = 0.0
        stopped = False
        pending_frames = None   # device handle of the previous chunk's maps

        def _camera():
            """Camera from the frame streamer's ``view_state`` (the live
            viewer's zoom/pan) as rasterizer world units: ``(max_view,
            cu, cv)`` — TRACED scalars, so per-chunk changes recompile
            nothing.  None when the streamer has no camera (fixed-view
            consumers keep the config-baked trace)."""
            vs = getattr(frame_streamer, "view_state", None)
            if vs is None:
                return None
            zoom, cx, cy = vs()
            return (cfg.max_view / zoom, cx * cfg.max_view,
                    cy * cfg.max_view)

        def _poll_control() -> bool:
            """Run control from the frame streamer (the live viewer's
            /stop /pause /resume — the reference's close-window-to-stop,
            main.cpp:118, without killing the process).  Returns True
            when the run should stop; blocks while paused (the device is
            idle between chunks, so pausing costs nothing)."""
            ctl = getattr(frame_streamer, "control_state", None)
            if ctl is None:
                return False
            state = ctl()
            while state == "pause":
                time.sleep(0.25)
                state = ctl()
            if state == "stop":
                if checkpoint_path:
                    save_checkpoint(checkpoint_path, self.state,
                                    self.step_count, cfg)
                self.logger.banner(
                    f"== run stopped by viewer control at step "
                    f"{self.step_count}"
                    + (f" (checkpointed -> {checkpoint_path})"
                       if checkpoint_path else "") + " ==")
                return True
            return False

        def _drain_pending():
            # Materialize + submit the previous chunk's frames.  Called
            # right AFTER the next chunk is dispatched, so the device->host
            # frame transfer overlaps that chunk's compute.
            nonlocal pending_frames, frame_idx
            if pending_frames is None:
                return
            from ..viz.raster import colorize
            for f in np.asarray(pending_frames):
                frame_streamer.submit(frame_idx, colorize(f))
                frame_idx += 1
            pending_frames = None

        # Warm-up compile outside the timed region (first call compiles).
        while done < n_steps:
            todo = min(chunk, n_steps - done)
            for c in boundary_cadences:
                todo = min(todo, c - done % c)
            first = done == 0
            t0 = time.perf_counter() if first else 0.0
            if not first:
                timer.start()
            if viz:
                # packed weight maps ship 1 byte/pixel (the stream is
                # device->host bandwidth-bound); colorized on submit.
                if self.mesh is not None:
                    # Mesh twin: render local shards in-loop, max-combine
                    # across devices with pmax — pixel-identical to
                    # rendering the gathered state.
                    from ..parallel.ring import run_trajectory_frames_sharded
                    self.state, frames = run_trajectory_frames_sharded(
                        self.state, cfg, self.mesh, todo,
                        frame_every=cfg.viz_every, impl=self.impl,
                        comm=self.comm, view=_camera())
                else:
                    from ..ops.step import run_trajectory_frames
                    self.state, frames = run_trajectory_frames(
                        self.state, cfg, todo, frame_every=cfg.viz_every,
                        impl=self.impl, packed=True,
                        view=_camera())            # async dispatch
                _drain_pending()
                pending_frames = frames
            else:
                self._run_chunk(todo)
            sync(self.state.pos)
            if not first:
                timer.stop(todo)
            else:
                first_chunk_s = time.perf_counter() - t0
            done += todo
            self.step_count += todo

            if nan_watchdog:
                probe = np.asarray(self.state.pos[:1])
                if not np.all(np.isfinite(probe)):
                    raise FloatingPointError(
                        f"non-finite positions at step {self.step_count}; "
                        f"reduce dt or check initial conditions")

            if checkpoint_every > 0 and checkpoint_path and (
                    done % checkpoint_every == 0 or done == n_steps):
                save_checkpoint(checkpoint_path, self.state,
                                self.step_count, cfg)

            if sort_every > 0 and done % sort_every == 0 and done < n_steps:
                from .ordering import morton_sort_state
                self.state, _ = morton_sort_state(
                    self.state, -cfg.max_pos, cfg.max_pos)

            if log_every > 0 and timer.total_steps:
                self.logger.log(
                    step=self.step_count,
                    sim_time=self.step_count * cfg.dt,
                    ms_per_step=round(timer.ms_per_step, 4),
                    steps_per_s=round(timer.steps_per_s, 3),
                    ginter_per_s=round(timer.ginter_per_s, 2),
                )

            if done < n_steps and _poll_control():
                stopped = True
                break

        _drain_pending()   # last chunk's frames

        if checkpoint_path and checkpoint_every <= 0 and not stopped:
            # A checkpoint path without a cadence means "save the end state"
            # (a viewer-stop already checkpointed inside _poll_control).
            save_checkpoint(checkpoint_path, self.state, self.step_count, cfg)

        e1 = self._total_energy() if track_energy else None
        if timer.total_steps:
            ms_per_step = timer.ms_per_step
            ginter = timer.ginter_per_s
        else:
            # Every step landed in the single (compile-inclusive) chunk;
            # report that rather than 0 (upper bound on the true cost).
            steps0 = max(1, done)
            ms_per_step = 1000.0 * first_chunk_s / steps0
            ginter = float(cfg.n_bodies) ** 2 * steps0 / first_chunk_s / 1e9 \
                if first_chunk_s else 0.0
        result = SimResult(
            state=self.state, steps_run=done,
            ms_per_step=ms_per_step,
            ginter_per_s=ginter,
            energy_initial=e0, energy_final=e1)
        if track_energy:
            self.logger.log(step=self.step_count,
                            sim_time=self.step_count * cfg.dt,
                            energy=e1, energy_drift=result.energy_drift)
        return result
