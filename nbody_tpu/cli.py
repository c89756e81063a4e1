"""Command-line interface.

The reference's UX is an interactive stdin dialog: kernel type (0=tiled,
1=reduction), visualization y/n, step count (``main.cpp:163-228``), with
everything else fixed at compile time in ``constants.h``.  Here every choice
is a flag, runtime-switchable (SURVEY.md section 7 design translation).

Subcommands:
  run       simulate (the reference's main flow, headless or with frame export)
  validate  lock-step differential test vs the CPU oracle
            (the reference's dormant compareHostToDevice, validation.cpp:55)
  bench     throughput sweep -> ms/step, GInter/s, optional energy drift
  info      device properties (the reference's print_device_prop, utils.cpp:49)
  render    rasterize a saved trajectory/checkpoint to PNG frames
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Optional

import numpy as np


class _TrackedStore(argparse.Action):
    """``store`` that additionally records which options were explicitly
    passed on the command line (``namespace._explicit``), so ``--resume``
    can merge only user-set flags onto a checkpoint's saved config instead
    of silently re-imposing argparse defaults (changing physics)."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        if not hasattr(namespace, "_explicit"):
            namespace._explicit = set()
        namespace._explicit.add(self.dest)


# CLI sim flags -> SimConfig fields (used for resume merging).
_ARG_TO_CFG = {
    "n": "n_bodies", "steps": "steps", "dt": "dt", "eps2": "eps2",
    "impl": "impl", "integrator": "integrator", "seed": "seed",
    "max_pos": "max_pos", "min_mass": "min_mass", "max_mass": "max_mass",
    "block_i": "block_i", "block_j": "block_j", "chunk": "chunk",
    "dtype": "dtype",
}


def _apply_dtype(args):
    """float64 state needs jax x64 enabled before any array is created."""
    if getattr(args, "dtype", "float32") == "float64":
        import jax
        jax.config.update("jax_enable_x64", True)


def _add_sim_args(p: argparse.ArgumentParser):
    from .config import DEFAULT_BLOCK_I, DEFAULT_BLOCK_J, VALID_IMPLS
    p.add_argument("--n", type=int, default=8192, action=_TrackedStore,
                   help="number of bodies (reference N_BODIES=8192)")
    p.add_argument("--steps", type=int, default=100, action=_TrackedStore)
    p.add_argument("--dt", type=float, default=0.1, action=_TrackedStore)
    p.add_argument("--eps2", type=float, default=0.002, action=_TrackedStore)
    p.add_argument("--impl", default="auto", action=_TrackedStore,
                   choices=VALID_IMPLS,
                   help="force backend (reference kernel-type prompt): "
                        "pallas = the tiled GPU kernel, xla_nxn = "
                        "broadcast+reduce, xla = chunked; auto picks by "
                        "device, dtype and N")
    p.add_argument("--integrator", default="reference", action=_TrackedStore,
                   choices=["reference", "kdk", "yoshida4"])
    p.add_argument("--seed", type=int, default=0, action=_TrackedStore)
    p.add_argument("--init", default="uniform",
                   choices=["uniform", "plummer", "plummer-virial", "disk",
                            "collision"],
                   help="initial conditions: uniform box (the reference's "
                        "utils.cpp:30-37), cold/virialized Plummer sphere, "
                        "rotating disk, or two-cluster collision "
                        "(models/init.py)")
    p.add_argument("--max-pos", type=float, default=100_000.0,
                   action=_TrackedStore)
    p.add_argument("--min-mass", type=float, default=100_000.0,
                   action=_TrackedStore)
    p.add_argument("--max-mass", type=float, default=1_000_000_000.0,
                   action=_TrackedStore)
    p.add_argument("--dtype", default="float32", action=_TrackedStore,
                   choices=["float32", "float64", "bfloat16"],
                   help="state precision; float64 enables jax x64 "
                        "(xla backends only), float32 matches the reference")
    p.add_argument("--block-i", type=int, default=DEFAULT_BLOCK_I,
                   action=_TrackedStore,
                   help="tiled kernel: bodies per program (power of two)")
    p.add_argument("--block-j", type=int, default=DEFAULT_BLOCK_J,
                   action=_TrackedStore,
                   help="tiled kernel: bodies per j-tile (power of two)")
    p.add_argument("--chunk", type=int, default=1024, action=_TrackedStore)
    p.add_argument("--shards", type=int, default=0,
                   help="shard bodies over this many devices (0 = single)")
    p.add_argument("--comm", default="ring",
                   choices=["ring", "allgather"],
                   help="sharded sweep: ppermute ring or Ulysses "
                        "all-gather (parallel/ring.py)")


def _make_cfg(args):
    from .config import SimConfig
    _apply_dtype(args)
    return SimConfig(
        n_bodies=args.n, steps=args.steps, dt=args.dt, eps2=args.eps2,
        impl=args.impl, integrator=args.integrator, seed=args.seed,
        max_pos=args.max_pos, min_mass=args.min_mass, max_mass=args.max_mass,
        block_i=args.block_i, block_j=args.block_j, chunk=args.chunk,
        dtype=getattr(args, "dtype", "float32"),
        viz=getattr(args, "viz", False),
        viz_every=getattr(args, "viz_every", 1) or 1,
    )


def _make_sim(args, cfg, logger):
    from .models.init import INIT_MAKERS
    from .models.simulation import Simulation
    mesh = None
    if args.shards:
        from .parallel.mesh import make_mesh
        mesh = make_mesh(args.shards)
    if getattr(args, "resume", None):
        explicit = getattr(args, "_explicit", set())
        overrides = {field: getattr(args, arg)
                     for arg, field in _ARG_TO_CFG.items() if arg in explicit}
        return Simulation.resume(args.resume, cfg=cfg, logger=logger,
                                 overrides=overrides, mesh=mesh,
                                 comm=getattr(args, "comm", "ring"))
    # Uniform init is left to Simulation (state=None) so mesh runs are
    # born sharded.
    maker = INIT_MAKERS.get(args.init)
    state = maker(cfg) if maker is not None else None
    return Simulation(cfg, state=state, logger=logger, mesh=mesh,
                      comm=getattr(args, "comm", "ring"))


def cmd_run(args) -> int:
    from .io.logger import RunLogger
    logger = RunLogger(jsonl_path=args.log_jsonl, csv_path=args.log_csv,
                       quiet=args.quiet)
    cfg = _make_cfg(args)
    sim = _make_sim(args, cfg, logger)

    if args.save_trajectory:
        # Trajectory-capture path: snapshots accumulate on device in one
        # compiled scan, then export to NPZ (nbody render consumes it).  A
        # mesh run steps through Simulation._run_chunk and STREAMS
        # snapshots to the NPZ one at a time (host memory stays O(one
        # snapshot)).
        from .io.checkpoint import TrajectoryWriter, save_trajectory
        from .ops.step import run_trajectory
        snap_every = max(1, args.snap_every)
        if sim.mesh is not None:
            with TrajectoryWriter(args.save_trajectory, snap_every, cfg,
                                  mass=np.asarray(sim.state.mass)) as tw:
                for _ in range(args.steps // snap_every):
                    sim._run_chunk(snap_every)
                    tw.append(np.asarray(sim.state.pos),
                              vel=(np.asarray(sim.state.vel)
                                   if args.traj_vel else None))
                rem = args.steps - (args.steps // snap_every) * snap_every
                if rem:
                    sim._run_chunk(rem)
                n_snaps = tw.n_snaps
        elif args.traj_vel:
            final, snaps, vsnaps = run_trajectory(
                sim.state, cfg, args.steps, snap_every=snap_every,
                impl=sim.impl, with_vel=True)
            save_trajectory(args.save_trajectory, np.asarray(snaps),
                            snap_every, cfg, mass=np.asarray(final.mass),
                            vel_snapshots=np.asarray(vsnaps))
            n_snaps = snaps.shape[0]
        else:
            final, snaps = run_trajectory(
                sim.state, cfg, args.steps, snap_every=snap_every,
                impl=sim.impl)
            save_trajectory(args.save_trajectory, np.asarray(snaps),
                            snap_every, cfg, mass=np.asarray(final.mass))
            n_snaps = snaps.shape[0]
        if not args.quiet:
            print(f"saved {n_snaps} snapshots -> {args.save_trajectory}")
        logger.close()
        return 0
    streamer = None
    sinks = []
    if args.viz:
        from .viz.stream import FrameStreamer
        sinks.append(FrameStreamer(args.viz_dir))
    if getattr(args, "viz_avi", None):
        from .viz.video import video_streamer
        sinks.append(video_streamer(args.viz_avi, cfg.viz_width,
                                    cfg.viz_height, fps=args.viz_fps))
    if getattr(args, "viz_serve", None) is not None:
        from .viz.server import LiveViewer
        viewer = LiveViewer(port=args.viz_serve)
        print(f"live view: http://127.0.0.1:{viewer.port}/ "
              f"(PNG multipart stream at /stream)")
        sinks.append(viewer)
    if len(sinks) == 1:
        streamer = sinks[0]
    elif sinks:
        from .viz.stream import TeeStreamer
        streamer = TeeStreamer(*sinks)
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        import jax
        profile_ctx = jax.profiler.trace(args.profile)
    try:
        with profile_ctx:
            result = sim.run(
                n_steps=args.steps, log_every=args.log_every,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                frame_streamer=streamer,
                track_energy=args.energy,
                sort_every=args.sort_every)
    finally:
        if streamer is not None:
            streamer.close()
        logger.close()
    if not args.quiet:
        print(f"Simulation complete: {result.steps_run} steps, "
              f"{result.ms_per_step:.3f} ms/step, "
              f"{result.ginter_per_s:{'.1f' if result.ginter_per_s >= 10 else '.3g'}} GInter/s"
              + (f", energy drift {result.energy_drift:.3e}"
                 if result.energy_drift is not None else ""))
        if streamer is not None and args.viz:
            print(f"{streamer.frames_written} frames -> {args.viz_dir}")
        elif streamer is not None:
            print(f"{streamer.frames_written} frames served")
    return 0


def cmd_validate(args) -> int:
    """Lock-step differential test against a CPU oracle — the reference's
    compareHostToDevice (validation.cpp:55-103) as a first-class command.

    A note on horizons: softened all-pairs gravity at the reference's
    parameters (uniform box, dt=0.1) is strongly chaotic — close encounters
    amplify last-bit rounding differences exponentially, so *any* two
    implementations (including the reference's own fp32 GPU vs fp32 CPU
    pair) diverge beyond a 1% position tolerance within a few tens of
    steps.  Per-component comparison is therefore gated at a short horizon
    (default 10 steps — the measured clean horizon at strict zero
    bad-components; the horizon counts FORCE SWEEPS, so yoshida4's three
    sweeps per step shrink it ~3x in steps — validate yoshida4 at fewer
    steps or smaller dt), and the DEFAULT run then continues to the
    reference harness's full horizon (1,000 lock-step steps,
    ``validation.cpp:65``) gated on integral quantities: device total
    energy vs oracle total energy (--energy-gate, applied when the f64
    oracle itself conserves energy at the horizon — i.e. the physics is
    well-posed, which the reference's own parameters are not: their
    close encounters are unresolvable at dt=0.1), plus the exactly-conserved
    momentum and angular momentum (--invariant-gate), which chaos cannot
    excuse and an asymmetric force-law bug breaks immediately.

    ``--shards P`` runs every device-side phase through the production
    sharded path (``run_steps_sharded``) so a multi-device user validates
    the execution path they will actually run.
    """
    from .config import SimConfig
    from .models.energy import energy_f64
    from .models.init import INIT_MAKERS, init_state
    from .models.state import SimState
    from .ops.step import prime_kdk, run_steps
    from .oracle.numpy_oracle import oracle_run, relative_mismatch
    if args.shards and args.analytic:
        print("--analytic gates are two-body closed-form checks and run "
              "single-device; drop --shards", file=sys.stderr)
        return 2
    if args.analytic:
        # Closed-form two-body gates (models/kepler.py) — validation against
        # EXACT solutions rather than a differential oracle; the one gate
        # family a shared-bug pair of implementations cannot fool.  Runs the
        # configured backend (the tiled kernel pads N with inert ghosts).
        from .models.kepler import run_analytic_gates
        results = run_analytic_gates(
            impl=args.impl, dtype=args.dtype,
            steps_per_period=args.steps if args.steps > 20 else 2048,
            block_i=args.block_i)
        ok = True
        for r in results:
            status = "OK " if r["ok"] else "FAIL"
            ok = ok and r["ok"]
            print(f"[{status}] {r['gate']}: max rel pos err "
                  f"{r['max_rel_err']:.3e} after {r['steps']} steps "
                  f"(1 period; tol {r['tol']:.3e})")
        print("Analytic verification " + ("PASSED" if ok else "FAILED"))
        return 0 if ok else 1
    cfg = _make_cfg(args)
    mesh = None
    if args.shards:
        # Validate the PRODUCTION sharded execution path: the strict
        # short-horizon gate and the long-horizon energy/invariant gates
        # run through run_steps_sharded, exactly the routing a mesh run
        # gets from Simulation.  The reference bar: the oracle harness
        # validates the execution path the production loop actually uses
        # (validation.cpp:65-86).
        from .parallel.mesh import make_mesh
        from .parallel.ring import (_resolve_local_impl, prime_kdk_sharded,
                                    run_steps_sharded)
        mesh = make_mesh(args.shards)
        comm = getattr(args, "comm", "ring")
        local_impl = _resolve_local_impl(cfg, args.impl)

        def dev_run(st, ns):
            return run_steps_sharded(st, cfg, mesh, ns,
                                     impl=local_impl, comm=comm)
    else:
        def dev_run(st, ns):
            return run_steps(st, cfg, ns)
    maker = INIT_MAKERS.get(args.init, init_state)
    state = maker(cfg)
    if cfg.integrator != "reference":
        state = (prime_kdk_sharded(state, cfg, mesh, impl=local_impl,
                                   comm=comm)
                 if mesh is not None else prime_kdk(state, cfg))
    pos0, vel0 = np.asarray(state.pos), np.asarray(state.vel)
    mass = np.asarray(state.mass)

    dev = dev_run(state, args.steps)
    dtype = np.float32 if args.oracle_f32 else np.float64
    if args.oracle == "native" and cfg.integrator == "yoshida4":
        # The native oracle twins only the reference/kdk schemes; the numpy
        # twin covers yoshida4 (oracle/numpy_oracle.py::oracle_run).
        print("native oracle has no yoshida4 twin; falling back to numpy")
        args.oracle = "numpy"
    if args.oracle == "native":
        from .oracle.native import available, native_run
        if not available():
            print("native oracle unavailable (build native/ with make); "
                  "falling back to numpy")
            opos, ovel, oacc = oracle_run(pos0, vel0, mass, cfg.eps2,
                                          cfg.dt, args.steps, dtype=dtype,
                                          integrator=cfg.integrator)
        else:
            opos, ovel, oacc = native_run(pos0, vel0, mass, cfg.eps2,
                                          cfg.dt, args.steps, dtype=dtype,
                                          integrator=cfg.integrator)
    else:
        opos, ovel, oacc = oracle_run(pos0, vel0, mass, cfg.eps2, cfg.dt,
                                      args.steps, dtype=dtype,
                                      integrator=cfg.integrator)
    ok = True
    # acc gets its own allowance: acceleration is the raw chaos-amplified
    # derivative (pos/vel are its integrals, smoothed), so a few acc
    # components of near-cancelling sums cross 1% by step 10 while pos/vel
    # stay at exactly 0.  The reference gates all three at the same 1% but never FAILS on
    # any of them (verify_still_bodies prints and returns,
    # validation.cpp:142-165) — strict-0 pos/vel plus a 5e-4 acc
    # allowance is already a harder gate than the reference enforces.
    for name, d, o, abs_tol, bad_frac in (
            ("pos", dev.pos, opos, args.abs_tol_pos, args.max_bad_frac),
            ("vel", dev.vel, ovel, args.abs_tol_vel, args.max_bad_frac),
            ("acc", dev.acc, oacc, args.abs_tol_acc,
             args.max_bad_frac_acc)):
        bad = relative_mismatch(np.asarray(d), o, args.rel_tol, abs_tol)
        frac = float(bad.mean())
        status = "OK " if frac <= bad_frac else "FAIL"
        if frac > bad_frac:
            ok = False
        print(f"[{status}] {name}: {frac:.4%} of components outside "
              f"{args.rel_tol:.1%} relative tolerance "
              f"({int(bad.sum())}/{bad.size})")
    # Momentum diagnostic (analytically conserved at exactly 0 from the
    # v=0 init; numeric drift should be tiny relative to the momentum scale).
    vel_f = np.asarray(dev.vel, dtype=np.float64)
    mass_f = np.asarray(dev.mass, dtype=np.float64)
    p_net = np.abs((mass_f[:, None] * vel_f).sum(axis=0)).max()
    p_scale = float((mass_f * np.linalg.norm(vel_f, axis=1)).sum()) or 1.0
    print(f"[INFO] momentum drift: |P|_max/scale = {p_net / p_scale:.3e}")
    # Angular momentum diagnostic: every integrator here composes kicks
    # (central pair forces at fixed positions -> zero torque) and drifts
    # (dr parallel to v) so L about the COM is conserved EXACTLY — from
    # the v=0 init L stays 0 up to rounding (analysis.angular_momentum).
    from .analysis import angular_momentum
    pos_f = np.asarray(dev.pos, dtype=np.float64)
    l_net = np.abs(angular_momentum(pos_f, vel_f, mass_f)).max()
    com = (mass_f[:, None] * pos_f).sum(axis=0) / mass_f.sum()
    l_scale = float((mass_f * np.linalg.norm(pos_f - com, axis=1)
                     * np.linalg.norm(vel_f, axis=1)).sum()) or 1.0
    print(f"[INFO] angular momentum drift: |L|_max/scale = "
          f"{l_net / l_scale:.3e}")
    if args.long_steps > 0:
        # Long-horizon phase (default ON — the reference's dormant harness
        # ran 1,000 lock-step steps, validation.cpp:65).  Per-component
        # comparison is meaningless at this horizon (chaos, see the
        # docstring), so correctness is gated on integral quantities:
        #   - ENERGY device-vs-oracle, hard-gated at --energy-gate, but
        #     ONLY when the f64 oracle itself conserves energy at this
        #     horizon (well-posed physics).  At the reference's own
        #     parameters the f64 oracle violates conservation by orders of
        #     magnitude (unresolvable close encounters) — device-vs-oracle
        #     energy there compares two exploding quantities and is
        #     reported, not gated.
        #   - MOMENTUM and ANGULAR MOMENTUM of the device run, which the
        #     composed kick/drift updates conserve EXACTLY regardless of
        #     chaos (an asymmetric force-law bug breaks them immediately).
        ls = args.long_steps
        dev_l = dev_run(state, ls)
        # The oracle twin prefers the native f64 build for this phase
        # (minutes at N=8192 vs far longer for numpy); yoshida4 has
        # only the numpy twin, and an EXPLICIT `--oracle numpy` is
        # honored here too — a user cross-checking a suspect native
        # build must not have the long-horizon gates silently validated
        # against the implementation they opted out of.
        from .oracle.native import available as _native_ok
        from .oracle.native import native_run
        explicit_numpy = (args.oracle == "numpy"
                          and "oracle" in getattr(args, "_explicit", set()))
        if (cfg.integrator != "yoshida4" and _native_ok()
                and not explicit_numpy):
            lpos, lvel, lacc = native_run(pos0, vel0, mass, cfg.eps2,
                                          cfg.dt, ls, dtype=np.float64,
                                          integrator=cfg.integrator)
            lsrc = "native"
        else:
            lpos, lvel, lacc = oracle_run(pos0, vel0, mass, cfg.eps2,
                                          cfg.dt, ls, dtype=np.float64,
                                          integrator=cfg.integrator)
            lsrc = "numpy"
        e0 = energy_f64(state, cfg.eps2)
        e_dev = energy_f64(dev_l, cfg.eps2)
        e_ora = energy_f64(
            SimState(pos=lpos, vel=lvel, acc=lacc, mass=mass), cfg.eps2)
        chaos = abs(e_ora - e0) / (abs(e0) or 1.0)
        drift = abs(e_dev - e_ora) / (abs(e_ora) or 1.0)
        well_posed = chaos <= args.energy_gate
        print(f"[long] {ls}-step horizon vs {lsrc} f64 oracle: oracle "
              f"self-conservation |dE|/|E0| = {chaos:.3e} -> "
              + ("well-posed" if well_posed else "chaos-dominated"))
        if well_posed:
            status = "OK " if drift <= args.energy_gate else "FAIL"
            if drift > args.energy_gate:
                ok = False
            print(f"[{status}] energy: device vs oracle drift {drift:.3e} "
                  f"(gate {args.energy_gate:.1e})")
        else:
            print(f"[INFO] energy: device vs oracle drift {drift:.3e} "
                  f"(not gateable: the configuration's close encounters "
                  f"are unresolvable at dt={cfg.dt:g}, eps2={cfg.eps2:g} "
                  f"— the oracle itself does not conserve energy)")
        vel_l = np.asarray(dev_l.vel, dtype=np.float64)
        pos_l = np.asarray(dev_l.pos, dtype=np.float64)
        p_net = np.abs((mass_f[:, None] * vel_l).sum(axis=0)).max()
        p_scale = float((mass_f * np.linalg.norm(vel_l, axis=1)).sum()) or 1.0
        p_drift = p_net / p_scale
        status = "OK " if p_drift <= args.invariant_gate else "FAIL"
        if p_drift > args.invariant_gate:
            ok = False
        print(f"[{status}] momentum: |P|_max/scale = {p_drift:.3e} after "
              f"{ls} steps (exactly conserved; gate "
              f"{args.invariant_gate:.1e})")
        l_net = np.abs(angular_momentum(pos_l, vel_l, mass_f)).max()
        com_l = (mass_f[:, None] * pos_l).sum(axis=0) / mass_f.sum()
        l_scale = float((mass_f * np.linalg.norm(pos_l - com_l, axis=1)
                         * np.linalg.norm(vel_l, axis=1)).sum()) or 1.0
        l_drift = l_net / l_scale
        status = "OK " if l_drift <= args.invariant_gate else "FAIL"
        if l_drift > args.invariant_gate:
            ok = False
        print(f"[{status}] angular momentum: |L|_max/scale = {l_drift:.3e} "
              f"after {ls} steps (exactly conserved; gate "
              f"{args.invariant_gate:.1e})")
    print("Verification " + ("PASSED" if ok else "FAILED")
          + f" after {args.steps} lock-step steps vs {args.oracle} "
          f"{'float32' if args.oracle_f32 else 'float64'} oracle"
          + (f" + {args.long_steps}-step long-horizon gates"
             if args.long_steps > 0 else ""))
    return 0 if ok else 1


def cmd_bench(args) -> int:
    from .bench_lib import run_benchmark
    # --steps defaults to the run command's 100; for bench, an unset
    # --steps means "auto" (bench_lib scales the trial length so small-N
    # trials measure the kernel, not dispatch latency).
    explicit = getattr(args, "_explicit", set())
    result = run_benchmark(
        n=args.n, steps=args.steps if "steps" in explicit else None,
        impl=args.impl,
        block_i=args.block_i, block_j=args.block_j, chunk=args.chunk,
        shards=args.shards or None, comm=args.comm,
        energy=args.energy, warmup_steps=args.warmup, trials=args.trials)
    print(json.dumps(result))
    return 0


def cmd_info(args) -> int:
    from .utils.device import print_device_info
    print_device_info()
    return 0


def cmd_interactive(args) -> int:
    """The reference's interactive console UX, 1:1 (main.cpp:163-228):
    kernel type (0 = tiled all-pairs, 1 = interaction-parallel/reduction),
    visualization y/n, step count — with retry loops on bad input.

    Deliberate divergence: the reference FORCES
    visualization ON when the reduction kernel is chosen
    (main.cpp:319-322) because that kernel only exists in its render
    loop; here every kernel runs headless or visualized, so the question
    is asked independently — a capability superset, noted for parity."""

    def ask(prompt, parse, what):
        while True:
            try:
                return parse(input(prompt))
            except (ValueError, KeyError):
                print(f"Please insert a valid {what}")

    kernel = ask(
        "Select the kernel to launch "
        "(0: tiled all-pairs, 1: interaction-parallel): ",
        lambda s: {"0": 0, "1": 1}[s.strip()], "kernel type (0 or 1)")
    viz = ask("Enable visualization? (y/n): ",
              lambda s: {"y": True, "n": False}[s.strip().lower()],
              "choice (y or n)")
    steps = ask("Insert the number of steps to simulate: ",
                lambda s: int(s), "integer")

    # 0: the tiled kernel; 1: the reduction-family analog, XLA's
    # interaction-parallel broadcast+reduce path.
    impl = "pallas" if kernel == 0 else "xla_nxn"

    run_args = ["run", "--n", str(args.n), "--steps", str(steps),
                "--impl", impl,
                "--log-every", str(max(1, min(100, steps // 5)))]
    if viz:
        run_args += ["--viz", "--viz-dir", args.viz_dir,
                     "--viz-every", str(max(1, steps // 100))]
    print(f"Starting simulation: N={args.n}, steps={steps}, impl={impl}, "
          f"visualization={'on' if viz else 'off'}")
    return main(run_args)


def _load_trajectory(path: str) -> "tuple[np.ndarray, np.ndarray]":
    """Load (snapshots (T,N,3), mass (N,)) from a trajectory or checkpoint
    NPZ (both the monolithic and the streamed per-snapshot layouts;
    streamed snapshots load lazily, one at a time).  Masses drive the
    reference's central visual semantic — the mass->color lerp
    (simulation_visualization.cpp:46-56) — so they must be the persisted
    per-body values, not fabricated uniforms."""
    with np.load(path) as z:
        if "pos" in z.files and "snapshots" not in z.files \
                and not any(f.startswith("snap_") for f in z.files):
            # checkpoint: single frame
            snaps = z["pos"][None]
            mass = z["mass"] if "mass" in z.files else None
        else:
            snaps = mass = "defer"
    if isinstance(snaps, str):
        from .io.checkpoint import load_trajectory
        snaps, mass, _ = load_trajectory(path)
    if mass is None:
        # Legacy trajectory without masses: colors degenerate to flat
        # green (weight 0) — warn so users re-export with masses.
        print("warning: trajectory has no 'mass' array; rendering with "
              "uniform minimum mass (flat green)", file=sys.stderr)
        mass = np.full((snaps.shape[1],), 1e5, np.float32)
    return snaps, mass


def cmd_render(args) -> int:
    from .config import SimConfig
    from .viz.raster import render_frame
    from .viz.stream import FrameStreamer
    import jax.numpy as jnp
    snaps, mass = _load_trajectory(args.trajectory)
    cfg = SimConfig(n_bodies=snaps.shape[1])
    rendered = []
    avi = None
    if args.avi:
        from .viz.video import video_writer
        avi = video_writer(args.avi, args.width, args.height, fps=args.fps)
    with FrameStreamer(args.out_dir) as fs:
        for i, pos in enumerate(snaps):
            frame = render_frame(
                jnp.asarray(pos), jnp.asarray(mass), cfg.min_mass,
                cfg.max_mass, args.max_view, args.width, args.height)
            fs.submit(i, frame)
            if avi is not None:
                avi.add(np.asarray(frame))
            if args.gif:
                rendered.append(np.asarray(frame))
    print(f"rendered {snaps.shape[0]} frames -> {args.out_dir}")
    if avi is not None:
        avi.close()
        print(f"wrote {snaps.shape[0]}-frame video -> {args.avi}")
    if args.gif:
        from .viz.gif import write_gif
        n = write_gif(args.gif, rendered, delay_cs=args.gif_delay_cs)
        print(f"wrote {n}-frame GIF -> {args.gif}")
    return 0


def cmd_analyze(args) -> int:
    from .analysis import analyze_trajectory
    res = analyze_trajectory(args.trajectory, n_bins=args.bins,
                             energy_max_n=args.energy_max_n)
    if args.json:
        print(json.dumps(res))
        return 0
    steps = res["steps"]
    drift = res["com_drift"]
    lr = res["lagrangian_radii"]
    fracs = res["fractions"]
    has_e = "energy" in res
    has_inv = "momentum_drift" in res
    hdr = "  ".join(f"r{int(f * 100):02d}%" for f in fracs)
    ehdr = f"  {'dE/E0':>10}  {'virial_Q':>9}" if has_e else ""
    ihdr = f"  {'dP_rel':>9}  {'dL_rel':>9}" if has_inv else ""
    print(f"== trajectory analysis: {args.trajectory} "
          f"({len(steps)} snapshots) ==")
    print(f"{'step':>8}  {'com_drift':>12}  {hdr}{ehdr}{ihdr}")
    for k in range(len(steps)):
        radii = "  ".join(f"{r:11.4g}" for r in lr[k])
        erow = (f"  {res['energy_drift'][k]:>10.3e}"
                f"  {res['virial'][k]:>9.4g}" if has_e else "")
        irow = (f"  {res['momentum_drift'][k]:>9.2e}"
                f"  {res['ang_mom_drift'][k]:>9.2e}" if has_inv else "")
        print(f"{steps[k]:>8}  {drift[k]:>12.4g}  {radii}{erow}{irow}")
    if "energy_note" in res:
        print(f"[note] {res['energy_note']}")
    g0 = np.asarray(res["g_r_first"])
    g1 = np.asarray(res["g_r_last"])
    mid = slice(len(g0) // 8, len(g0) // 2)
    print(f"pair correlation g(r), mid-range mean: "
          f"first={g0[mid].mean():.3f} last={g1[mid].mean():.3f} "
          f"(1 = uniform; >1 = clustered)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="nbody",
        description="All-pairs N-body simulation framework")
    sub = ap.add_subparsers(dest="command", required=True)

    runp = sub.add_parser("run", help="run a simulation")
    _add_sim_args(runp)
    runp.add_argument("--viz", action="store_true",
                      help="stream PNG frames (replaces the GL window)")
    runp.add_argument("--viz-dir", default="frames")
    runp.add_argument("--viz-every", type=int, default=1)
    runp.add_argument("--viz-avi", "--viz-video", default=None,
                      metavar="VIDEO",
                      help="write rendered frames into an MJPEG video "
                           "during the run (one seekable file instead of "
                           "per-frame PNGs); container picked by extension "
                           "(.mp4/.m4v -> MP4, else AVI)")
    runp.add_argument("--viz-fps", type=int, default=25,
                      help="playback rate of --viz-avi")
    runp.add_argument("--viz-serve", type=int, default=None, metavar="PORT",
                      help="serve a live view over HTTP on this port "
                           "(the reference's 'watch it evolve' window, "
                           "main.cpp:118-133; 0 picks a free port)")
    runp.add_argument("--log-every", type=int, default=None,
                      help="progress-log cadence in steps (0 = none). "
                           "Default: auto — chunks sync the device for "
                           "the timer, so the cadence is sized to keep "
                           "one chunk >= ~0.5 s of device work (~<=50 "
                           "log lines per run); a fixed small cadence at "
                           "small N costs throughput")
    runp.add_argument("--log-jsonl", default=None)
    runp.add_argument("--log-csv", default=None)
    runp.add_argument("--checkpoint", default=None)
    runp.add_argument("--checkpoint-every", type=int, default=0)
    runp.add_argument("--resume", default=None,
                      help="resume from a checkpoint file")
    runp.add_argument("--energy", action="store_true",
                      help="report total-energy drift (float64)")
    runp.add_argument("--profile", default=None, metavar="DIR",
                      help="capture a jax.profiler trace into DIR")
    runp.add_argument("--sort-every", type=int, default=0,
                      help="Morton-resort bodies every K steps")
    runp.add_argument("--save-trajectory", default=None, metavar="NPZ",
                      help="capture position snapshots on device and save")
    runp.add_argument("--snap-every", type=int, default=1)
    runp.add_argument("--traj-vel", action="store_true",
                      help="also capture velocities in --save-trajectory "
                           "(doubles snapshot size; unlocks the "
                           "energy/virial and exact-invariant P/L drift "
                           "series in `nbody analyze`)")
    runp.add_argument("--quiet", action="store_true")
    runp.set_defaults(fn=cmd_run)

    vp = sub.add_parser("validate",
                        help="lock-step differential test vs CPU oracle")
    _add_sim_args(vp)
    # Default horizon: 10 steps, the clean horizon at strict max-bad-frac
    # 0; by 20 steps chaotic amplification of last-bit rounding puts a
    # handful of components past 1% for ANY implementation pair (see the
    # cmd_validate docstring).
    vp.set_defaults(steps=10)
    vp.add_argument("--rel-tol", type=float, default=0.01,
                    help="per-component relative tolerance "
                         "(reference: 1%%, validation.cpp:144)")
    vp.add_argument("--abs-tol-pos", type=float, default=1.0)
    vp.add_argument("--abs-tol-vel", type=float, default=1e-2)
    vp.add_argument("--abs-tol-acc", type=float, default=1e-6)
    vp.add_argument("--max-bad-frac", type=float, default=0.0)
    vp.add_argument("--max-bad-frac-acc", type=float, default=5e-4,
                    help="separate allowance for acc (the chaos-amplified "
                         "derivative; the reference never enforces any of "
                         "its three comparisons, validation.cpp:142-165)")
    vp.add_argument("--oracle", default="numpy", action=_TrackedStore,
                    choices=["numpy", "native"],
                    help="numpy (vectorized) or native (C++/OpenMP, the "
                         "reference validation.cpp analog); the long-"
                         "horizon phase auto-prefers native for speed "
                         "unless numpy is EXPLICITLY requested")
    vp.add_argument("--oracle-f32", action="store_true",
                    help="run the oracle in float32 (exactly the reference's "
                         "CPU_compute precision) instead of float64")
    vp.add_argument("--analytic", action="store_true",
                    help="validate against closed-form two-body (Kepler) "
                         "solutions instead of a CPU oracle: circular "
                         "orbits for both integrators (incl. the reference "
                         "scheme's half-force modified dynamics) and an "
                         "e=0.6 elliptic orbit; --steps>20 sets "
                         "steps/period (default 2048)")
    vp.add_argument("--long-steps", type=int, default=1000,
                    help="long-horizon phase length (default 1000 — the "
                         "reference harness's lock-step count, "
                         "validation.cpp:65); gates energy vs the f64 "
                         "oracle when the physics is well-posed plus the "
                         "exactly-conserved invariants (momentum, angular "
                         "momentum); 0 disables")
    vp.add_argument("--energy-gate", type=float, default=1e-3,
                    help="long-horizon gate on |E_dev - E_oracle|/"
                         "|E_oracle|; applied only when the oracle itself "
                         "conserves energy to within this at the horizon "
                         "— at chaos-dominated configs (the reference's "
                         "own parameters) the drift is reported, not "
                         "gated")
    vp.add_argument("--invariant-gate", type=float, default=1e-3,
                    help="long-horizon gate on the exactly-conserved "
                         "invariants |P| and |L| (scale-relative)")
    vp.set_defaults(fn=cmd_validate)

    bp = sub.add_parser("bench", help="throughput benchmark")
    _add_sim_args(bp)
    bp.add_argument("--warmup", type=int, default=None,
                    help="warmup steps (default: same as --steps, so the "
                         "warmup shares the timed trials' compiled program)")
    bp.add_argument("--trials", type=int, default=3,
                    help="independent timed trials; headline is the median")
    bp.add_argument("--energy", action="store_true")
    bp.set_defaults(fn=cmd_bench)

    ip = sub.add_parser("info", help="device properties")
    ip.set_defaults(fn=cmd_info)

    itp = sub.add_parser(
        "interactive",
        help="the reference's stdin console flow (main.cpp:163-228)")
    itp.add_argument("--n", type=int, default=8192)
    itp.add_argument("--viz-dir", default="frames")
    itp.set_defaults(fn=cmd_interactive)

    rp = sub.add_parser("render", help="rasterize saved trajectory to PNGs")
    rp.add_argument("trajectory")
    rp.add_argument("--out-dir", default="frames")
    rp.add_argument("--width", type=int, default=800)
    rp.add_argument("--height", type=int, default=600)
    rp.add_argument("--max-view", type=float, default=200_000.0)
    rp.add_argument("--gif", default=None, metavar="GIF",
                    help="additionally assemble frames into an animated GIF")
    rp.add_argument("--gif-delay-cs", type=int, default=4)
    rp.add_argument("--avi", "--video", default=None, metavar="VIDEO",
                    help="additionally write an MJPEG video (long runs "
                         "get one seekable file instead of thousands of "
                         "PNGs; the reference's watch-it-evolve UX, "
                         "simulation_visualization.cpp:165-169); container "
                         "picked by extension (.mp4/.m4v -> MP4, else AVI)")
    rp.add_argument("--fps", type=int, default=25,
                    help="AVI playback rate")
    rp.set_defaults(fn=cmd_render)

    anp = sub.add_parser(
        "analyze",
        help="structure/health diagnostics from a saved trajectory "
             "(COM drift, Lagrangian radii, pair correlation)")
    anp.add_argument("trajectory")
    anp.add_argument("--bins", type=int, default=32)
    anp.add_argument("--json", action="store_true",
                     help="emit the full series as one JSON object")
    anp.add_argument("--energy-max-n", type=int, default=16384,
                     help="skip the O(N^2) host-f64 energy/virial series "
                          "above this many bodies (needs --traj-vel "
                          "trajectories)")
    anp.set_defaults(fn=cmd_analyze)
    return ap


def main(argv: Optional["list[str]"] = None) -> int:
    args = build_parser().parse_args(argv)
    # Persistent XLA compilation cache (utils/compcache.py): a cached
    # program reloads in a fraction of its compile time.
    from .utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
