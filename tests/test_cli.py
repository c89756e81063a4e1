"""CLI surface tests — the runtime replacement for the reference's stdin
prompts (main.cpp:163-228) and its dormant validation harness."""

import json
import os

import numpy as np
import pytest

from nbody_tpu.cli import main


def test_run_headless(capsys):
    rc = main(["run", "--n", "256", "--steps", "20", "--impl", "xla_nxn",
               "--log-every", "10"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Simulation complete" in out
    assert "GInter/s" in out


def test_run_with_energy_and_logs(tmp_path, capsys):
    jl = str(tmp_path / "run.jsonl")
    rc = main(["run", "--n", "128", "--steps", "10", "--impl", "xla_nxn",
               "--energy", "--log-jsonl", jl, "--quiet"])
    assert rc == 0
    records = [json.loads(l) for l in open(jl)]
    assert any("energy_drift" in r and r["energy_drift"] is not None
               for r in records)


def test_run_checkpoint_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    rc = main(["run", "--n", "128", "--steps", "10", "--impl", "xla_nxn",
               "--checkpoint", ck, "--checkpoint-every", "5", "--quiet"])
    assert rc == 0 and os.path.exists(ck)
    rc = main(["run", "--n", "128", "--steps", "5", "--impl", "xla_nxn",
               "--resume", ck, "--quiet"])
    assert rc == 0


def test_run_viz(tmp_path, capsys):
    vd = str(tmp_path / "frames")
    rc = main(["run", "--n", "64", "--steps", "4", "--impl", "xla_nxn",
               "--viz", "--viz-dir", vd, "--viz-every", "2", "--quiet"])
    assert rc == 0
    assert len(os.listdir(vd)) == 2


def test_validate_passes(capsys):
    rc = main(["validate", "--n", "256", "--steps", "50", "--impl", "xla_nxn"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASSED" in out


def test_validate_kdk_and_plummer(capsys):
    """validate must honor --integrator kdk (KDK oracle twin) and --init."""
    rc = main(["validate", "--n", "128", "--steps", "20", "--impl", "xla_nxn",
               "--integrator", "kdk", "--init", "plummer"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASSED" in out


def test_validate_analytic(capsys):
    """--analytic runs the closed-form Kepler gates (models/kepler.py)
    instead of the differential oracle; --steps > 20 sets steps/period."""
    rc = main(["validate", "--analytic", "--impl", "xla_nxn",
               "--steps", "1024"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "circular/reference" in out and "elliptic(e=0.6)/kdk" in out
    assert "Analytic verification PASSED" in out


def test_validate_default_horizon():
    """Out-of-box `nbody validate` uses the CLEAN horizon (10 steps, at
    strict max-bad-frac 0); at 20 steps chaotic amplification fails ANY
    implementation pair."""
    from nbody_tpu.cli import build_parser
    args = build_parser().parse_args(["validate"])
    assert args.steps == 10 and args.max_bad_frac == 0.0


def test_validate_long_horizon_default():
    """The long-horizon phase is the DEFAULT story: 1,000
    lock-step steps — the reference harness's own count
    (validation.cpp:65) — with the energy gate at 1e-3."""
    from nbody_tpu.cli import build_parser
    args = build_parser().parse_args(["validate"])
    assert args.long_steps == 1000
    assert args.energy_gate == 1e-3
    assert args.invariant_gate == 1e-3


def test_validate_long_horizon_chaos_dominated(capsys):
    """At the reference's own parameters the f64 oracle itself violates
    conservation: the energy drift is reported,
    not gated, and the exactly-conserved invariants gate instead."""
    rc = main(["validate", "--n", "128", "--impl", "xla_nxn"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "chaos-dominated" in out
    assert "[INFO] energy: device vs oracle drift" in out
    assert "[OK ] momentum: " in out
    assert "[OK ] angular momentum: " in out
    assert "long-horizon gates" in out


def test_validate_long_horizon_well_posed_energy_gate(capsys):
    """With well-posed softening and a symplectic integrator the oracle
    conserves at the horizon and the 1e-3 energy gate HARD-gates."""
    rc = main(["validate", "--n", "128", "--impl", "xla_nxn",
               "--integrator", "kdk", "--eps2", "1e8",
               "--long-steps", "200"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "well-posed" in out
    assert "[OK ] energy: device vs oracle drift" in out


def test_validate_long_steps_zero_disables(capsys):
    rc = main(["validate", "--n", "128", "--impl", "xla_nxn",
               "--long-steps", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[long]" not in out and "long-horizon" not in out


def test_validate_shards(capsys):
    """`nbody validate --shards P` runs the oracle gates through the
    PRODUCTION sharded path (run_steps_sharded + prime_kdk_sharded), so
    a user can drive validation on the mesh they'll run on.  Long horizon kept short (mesh geometry, conftest envelope)."""
    rc = main(["validate", "--n", "256", "--steps", "5", "--impl", "xla",
               "--shards", "8", "--long-steps", "20"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[long]" in out and "Verification PASSED" in out


def test_validate_shards_multiprog(capsys, kernel_interpret):
    """validate --shards with the tiled kernel as each device's local
    sweep of the ring (tiny geometry: interpret-mode kernel between
    collectives, see conftest envelope)."""
    rc = main(["validate", "--n", "256", "--steps", "3", "--impl",
               "pallas", "--shards", "4", "--block-i", "16",
               "--block-j", "32", "--long-steps", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Verification PASSED" in out


def test_validate_rejects_shards_with_analytic(capsys):
    rc = main(["validate", "--analytic", "--shards", "8"])
    assert rc == 2


def test_resume_keeps_saved_physics(tmp_path):
    """Resuming without re-passing --dt/--eps2 must keep the checkpoint's
    physics; explicitly-passed flags still override."""
    from nbody_tpu.models.simulation import Simulation
    ck = str(tmp_path / "ck.npz")
    rc = main(["run", "--n", "96", "--steps", "4", "--impl", "xla_nxn",
               "--dt", "0.025", "--eps2", "7.0", "--checkpoint", ck,
               "--quiet"])
    assert rc == 0
    # No overrides: saved physics wins over argparse defaults.
    sim = Simulation.resume(ck, overrides={})
    assert sim.cfg.dt == 0.025 and sim.cfg.eps2 == 7.0
    assert sim.cfg.n_bodies == 96 and sim.step_count == 4
    # Explicit override merges onto the saved config.
    sim = Simulation.resume(ck, overrides={"dt": 0.5})
    assert sim.cfg.dt == 0.5 and sim.cfg.eps2 == 7.0
    # n_bodies always reconciles with the restored state size.
    with pytest.warns(UserWarning, match="bodies"):
        sim = Simulation.resume(ck, overrides={"n_bodies": 4096})
    assert sim.cfg.n_bodies == 96


def test_cli_resume_merge_end_to_end(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    assert main(["run", "--n", "96", "--steps", "4", "--impl", "xla_nxn",
                 "--dt", "0.025", "--checkpoint", ck, "--quiet"]) == 0
    # Resume passing only --steps: must not silently reset dt to 0.1.
    assert main(["run", "--steps", "2", "--impl", "xla_nxn",
                 "--resume", ck, "--quiet"]) == 0


def test_validate_oracle_f32(capsys):
    """Reference-exact comparison mode: fp32 oracle (CPU_compute precision)."""
    rc = main(["validate", "--n", "128", "--steps", "20", "--impl", "xla_nxn",
               "--oracle-f32"])
    assert rc == 0


def test_bench_json(capsys):
    rc = main(["bench", "--n", "512", "--steps", "5", "--impl", "xla",
               "--chunk", "128", "--warmup", "1"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == "GInteractions/s"
    assert rec["value"] > 0 and rec["finite"]
    assert "vs_baseline" not in rec


def test_info(capsys):
    rc = main(["info"])
    assert rc == 0
    assert "Device Properties" in capsys.readouterr().out


def test_render(tmp_path, capsys):
    from nbody_tpu.io.checkpoint import save_trajectory
    snaps = (np.random.default_rng(0)
             .uniform(-1e5, 1e5, (3, 64, 3)).astype(np.float32))
    traj = str(tmp_path / "traj.npz")
    save_trajectory(traj, snaps, snap_every=1)
    out_dir = str(tmp_path / "frames")
    rc = main(["render", traj, "--out-dir", out_dir,
               "--width", "100", "--height", "80"])
    assert rc == 0
    assert len(os.listdir(out_dir)) == 3


def test_run_save_trajectory_then_render(tmp_path, capsys):
    traj = str(tmp_path / "t.npz")
    rc = main(["run", "--n", "64", "--steps", "6", "--impl", "xla_nxn",
               "--save-trajectory", traj, "--snap-every", "2", "--quiet"])
    assert rc == 0
    with np.load(traj) as z:
        assert z["snapshots"].shape == (3, 64, 3)
    out_dir = str(tmp_path / "fr")
    assert main(["render", traj, "--out-dir", out_dir]) == 0
    assert len(os.listdir(out_dir)) == 3


def test_trajectory_persists_mass_and_colors_vary(tmp_path):
    """Regression: trajectories must carry per-body masses so renders keep
    the reference's mass->color lerp (simulation_visualization.cpp:46-56)
    instead of collapsing to flat green."""
    import jax.numpy as jnp
    from nbody_tpu.cli import _load_trajectory
    from nbody_tpu.viz.raster import render_frame
    traj = str(tmp_path / "t.npz")
    rc = main(["run", "--n", "64", "--steps", "2", "--impl", "xla_nxn",
               "--max-mass", "1e9", "--save-trajectory", traj, "--quiet"])
    assert rc == 0
    with np.load(traj) as z:
        assert "mass" in z, "trajectory NPZ must persist masses"
    snaps, mass = _load_trajectory(traj)
    assert mass.shape == (64,)
    assert mass.std() > 0  # real per-body masses, not a fabricated uniform
    frame = np.asarray(render_frame(
        jnp.asarray(snaps[0]), jnp.asarray(mass), 1e5, 1e9, 2e5,
        width=200, height=150))
    lit = frame[frame.sum(axis=-1) > 0]
    # Color must vary with mass: red channel spread across lit pixels.
    assert lit.shape[0] > 1
    assert int(lit[:, 0].max()) - int(lit[:, 0].min()) > 50


def test_run_sort_every(capsys):
    rc = main(["run", "--n", "256", "--steps", "10", "--impl", "xla_nxn",
               "--sort-every", "5", "--quiet"])
    assert rc == 0


def test_run_plummer_init(capsys):
    rc = main(["run", "--n", "128", "--steps", "5", "--impl", "xla_nxn",
               "--init", "plummer", "--quiet"])
    assert rc == 0


def test_render_from_checkpoint(tmp_path):
    import jax.numpy as jnp
    from nbody_tpu import SimConfig, SimState
    from nbody_tpu.io.checkpoint import save_checkpoint
    r = np.random.default_rng(0)
    state = SimState(
        pos=jnp.asarray(r.uniform(-1e5, 1e5, (64, 3)).astype(np.float32)),
        vel=jnp.zeros((64, 3), jnp.float32),
        acc=jnp.zeros((64, 3), jnp.float32),
        mass=jnp.asarray(r.uniform(1e5, 1e9, 64).astype(np.float32)))
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, state, step=1, cfg=SimConfig(n_bodies=64))
    out_dir = str(tmp_path / "fr")
    assert main(["render", ck, "--out-dir", out_dir]) == 0
    assert len(os.listdir(out_dir)) == 1


def test_interactive_flow(monkeypatch, capsys):
    """Reference console parity: bad input retries, then a working run."""
    answers = iter(["7", "1", "maybe", "n", "not-a-number", "5"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    rc = main(["interactive", "--n", "128"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("Please insert a valid") == 3
    assert "Starting simulation" in out
    assert "Simulation complete" in out


def test_sharded_run(capsys):
    rc = main(["run", "--n", "512", "--steps", "5", "--impl", "xla",
               "--chunk", "64", "--shards", "8", "--quiet"])
    assert rc == 0


def test_run_save_trajectory_sharded(tmp_path, kernel_interpret):
    """--shards + --save-trajectory must route through the mesh; the
    sharded capture must match the single-device one."""
    traj_s = str(tmp_path / "sharded.npz")
    traj_1 = str(tmp_path / "single.npz")
    base = ["run", "--n", "64", "--steps", "6", "--impl", "pallas",
            "--block-i", "8", "--block-j", "16",
            "--save-trajectory", None, "--snap-every", "2", "--quiet"]
    args = list(base)
    args[args.index(None)] = traj_s
    assert main(args + ["--shards", "8"]) == 0
    args = list(base)
    args[args.index(None)] = traj_1
    assert main(args) == 0
    from nbody_tpu.io.checkpoint import load_trajectory
    snaps_s, _, _ = load_trajectory(traj_s)
    snaps_1, _, _ = load_trajectory(traj_1)
    got = np.stack([np.asarray(s) for s in snaps_s])
    want = np.stack([np.asarray(s) for s in snaps_1])
    assert got.shape == (3, 64, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-1)


def test_bench_value_matches_ms_per_step(capsys):
    """The headline value and ms_per_step must describe the SAME trial:
    n^2*steps/time must round-trip (independent medians of two sorted
    lists disagree at even trial counts)."""
    rc = main(["bench", "--n", "256", "--steps", "2", "--impl", "xla",
               "--warmup", "1", "--trials", "2"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n, steps = rec["n_bodies"], rec["steps"]
    implied = n * n * steps / (rec["ms_per_step"] * steps / 1e3) / 1e9
    assert abs(implied - rec["value"]) / rec["value"] < 5e-3
    assert rec["ginter_min"] <= rec["value"] <= rec["ginter_max"]


def test_validate_long_phase_honors_explicit_numpy_oracle(capsys, monkeypatch):
    """An explicit `--oracle numpy` pins the LONG-HORIZON phase to the
    numpy twin even when the native build is available — a user
    cross-checking a suspect native build must not have the gates
    silently validated against it.  Without the flag the
    phase auto-prefers native (speed)."""
    import numpy as np
    import nbody_tpu.oracle.native as nat
    from nbody_tpu.oracle.numpy_oracle import oracle_run

    calls = []

    def fake_native_run(pos0, vel0, mass, eps2, dt, steps,
                        dtype=np.float64, integrator="reference"):
        calls.append(steps)
        return oracle_run(pos0, vel0, mass, eps2, dt, steps,
                          dtype=dtype, integrator=integrator)

    monkeypatch.setattr(nat, "available", lambda: True)
    monkeypatch.setattr(nat, "native_run", fake_native_run)
    base = ["validate", "--n", "64", "--steps", "5", "--impl", "xla_nxn",
            "--dt", "0.01", "--long-steps", "8"]
    main(base + ["--oracle", "numpy"])
    out = capsys.readouterr().out
    assert "vs numpy f64 oracle" in out
    assert calls == []                       # native never touched
    main(base)                               # default: prefers native
    out = capsys.readouterr().out
    assert "vs native f64 oracle" in out and calls == [8]
