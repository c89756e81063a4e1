"""Trajectory analysis utilities (nbody_tpu/analysis.py).

The reference has no post-hoc analysis (outputs die with the GL window,
main.cpp:361-366); these diagnostics are gated against analytic
expectations: uniform-sphere g(r) ~ 1, uniform-sphere Lagrangian radii
~ f^(1/3) R, exact COM arithmetic, and a hand-computed two-body virial
ratio.
"""

import numpy as np
import pytest

from nbody_tpu.analysis import (
    analyze_trajectory, center_of_mass, com_drift, lagrangian_radii,
    pair_correlation, virial_ratio)


def uniform_sphere(n, radius=1.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, n) ** (1 / 3)
    return v * r[:, None]


def test_center_of_mass_weights():
    pos = np.array([[0.0, 0, 0], [1.0, 0, 0]])
    mass = np.array([1.0, 3.0])
    np.testing.assert_allclose(center_of_mass(pos, mass), [0.75, 0, 0])


def test_com_drift_zero_for_static_and_tracks_shift():
    pos = uniform_sphere(256, seed=1)
    mass = np.ones(256)
    snaps = np.stack([pos, pos, pos + np.array([2.0, 0, 0])])
    d = com_drift(snaps, mass)
    np.testing.assert_allclose(d[:2], 0.0, atol=1e-12)
    np.testing.assert_allclose(d[2], 2.0, rtol=1e-10)


def test_lagrangian_radii_uniform_sphere():
    """Enclosed mass of a uniform sphere: M(r)/M = (r/R)^3, so the
    f-fraction radius is f^(1/3) R."""
    pos = uniform_sphere(20000, radius=2.0, seed=2)
    mass = np.ones(20000)
    r = lagrangian_radii(pos, mass, (0.1, 0.5, 0.9))
    expect = 2.0 * np.array([0.1, 0.5, 0.9]) ** (1 / 3)
    np.testing.assert_allclose(r, expect, rtol=0.03)


def test_lagrangian_radii_ordering():
    pos = uniform_sphere(512, seed=3)
    mass = np.ones(512)
    r = lagrangian_radii(pos, mass, (0.1, 0.5, 0.9))
    assert r[0] < r[1] < r[2]


def test_pair_correlation_uniform_is_flat():
    """g(r) ~ 1 for a uniform sphere (the normalization's own null case);
    the innermost bins are noisy (few pairs), so gate the mid-range."""
    pos = uniform_sphere(4000, radius=1.0, seed=4)
    r, g = pair_correlation(pos, n_bins=32, chunk=1024)
    mid = g[4:16]
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(mid.mean(), 1.0, atol=0.05)
    assert mid.std() < 0.1


def test_pair_correlation_detects_clustering():
    """Two well-separated clumps: g at small r far exceeds 1."""
    a = uniform_sphere(500, radius=0.05, seed=5)
    b = uniform_sphere(500, radius=0.05, seed=6) + np.array([2.0, 0, 0])
    pos = np.concatenate([a, b])
    r, g = pair_correlation(pos, n_bins=32)
    assert g[:4].max() > 5.0


def test_virial_ratio_cold_start_and_two_body():
    """Cold start: Q = 0.  Two unit masses at separation d with speeds v
    each: Q = 2K/|W| = 2*(2*0.5*v^2) / (1/sqrt(d^2+eps2))."""
    pos = np.array([[0.0, 0, 0], [1.0, 0, 0]])
    mass = np.array([1.0, 1.0])
    assert virial_ratio(pos, np.zeros((2, 3)), mass, 0.0) == 0.0
    vel = np.array([[0.0, 0.5, 0], [0.0, -0.5, 0]])
    q = virial_ratio(pos, vel, mass, 0.0)
    # K = 2 * 0.5 * 1 * 0.25 = 0.25; |W| = 1*1/1 = 1; Q = 0.5
    np.testing.assert_allclose(q, 0.5, rtol=1e-12)


def test_analyze_trajectory_roundtrip(tmp_path):
    """End-to-end: save a trajectory NPZ, analyze it, check the series
    shapes and that a collapsing rescale shows shrinking radii."""
    from nbody_tpu.io.checkpoint import save_trajectory
    n, t = 512, 4
    base = uniform_sphere(n, radius=10.0, seed=7).astype(np.float32)
    mass = np.ones(n, np.float32)
    snaps = np.stack([base * (1.0 - 0.2 * k) for k in range(t)])
    path = str(tmp_path / "traj.npz")
    save_trajectory(path, snaps, snap_every=5, mass=mass)
    res = analyze_trajectory(path, n_bins=16)
    assert res["steps"] == [5, 10, 15, 20]
    lr = np.asarray(res["lagrangian_radii"])
    assert lr.shape == (t, 3)
    assert np.all(np.diff(lr[:, 1]) < 0)   # half-mass radius shrinks
    assert len(res["g_r_first"]) == 16


def test_analyze_cli(tmp_path, capsys):
    from nbody_tpu.cli import main
    from nbody_tpu.io.checkpoint import save_trajectory
    import json as _json
    n = 256
    base = uniform_sphere(n, radius=5.0, seed=8).astype(np.float32)
    snaps = np.stack([base, base * 0.9])
    path = str(tmp_path / "traj.npz")
    save_trajectory(path, snaps, snap_every=2, mass=np.ones(n, np.float32))
    assert main(["analyze", path]) == 0
    out = capsys.readouterr().out
    assert "trajectory analysis" in out and "pair correlation" in out
    assert main(["analyze", path, "--json"]) == 0
    res = _json.loads(capsys.readouterr().out)
    assert res["steps"] == [2, 4]


def test_angular_momentum_exactly_conserved():
    """Kick-drift compositions conserve L about the COM exactly (kicks:
    central pair forces at fixed positions, zero torque; drifts: dr || v)
    — all three integrators hold L at rounding scale in f64, from a WARM
    (nonzero-L) start."""
    import jax
    import jax.numpy as jnp
    from nbody_tpu import SimConfig, init_state, prime_kdk, run_steps
    from nbody_tpu.analysis import angular_momentum
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        rng = np.random.default_rng(5)
        for integ in ("reference", "kdk", "yoshida4"):
            cfg = SimConfig(n_bodies=128, impl="xla_nxn", dtype="float64",
                            dt=0.01, eps2=1.0, max_pos=10.0, min_mass=1.0,
                            max_mass=2.0, integrator=integ)
            state = init_state(cfg)
            vel0 = rng.normal(size=(128, 3))  # warm start: L0 != 0
            state = state._replace(vel=jnp.asarray(vel0))
            if integ != "reference":
                state = prime_kdk(state, cfg)
            l0 = angular_momentum(np.asarray(state.pos), vel0,
                                  np.asarray(state.mass))
            out = run_steps(state, cfg, 50)
            l1 = angular_momentum(np.asarray(out.pos), np.asarray(out.vel),
                                  np.asarray(out.mass))
            rel = np.abs(l1 - l0).max() / max(np.abs(l0).max(), 1e-30)
            assert rel < 1e-10, (integ, rel, l0, l1)
    finally:
        jax.config.update("jax_enable_x64", old)


def test_analyze_energy_virial_series(tmp_path):
    """Velocity-carrying trajectories unlock the energy/virial series;
    each entry must equal the direct f64 computation on that snapshot
    (virial_ratio / KE + W), and a static snapshot pair has zero drift."""
    from nbody_tpu.analysis import _potential_f64
    from nbody_tpu.io.checkpoint import save_trajectory
    from nbody_tpu.config import SimConfig
    n, eps2 = 128, 0.5
    rng = np.random.default_rng(9)
    base = uniform_sphere(n, radius=3.0, seed=9).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(1.0, 2.0, n).astype(np.float32)
    snaps = np.stack([base, base * 0.95])
    vels = np.stack([vel, vel * 1.1])
    path = str(tmp_path / "tv.npz")
    save_trajectory(path, snaps, snap_every=3, mass=mass,
                    cfg=SimConfig(n_bodies=n, eps2=eps2),
                    vel_snapshots=vels)
    res = analyze_trajectory(path, n_bins=8)
    assert res["eps2"] == eps2   # embedded config wins
    for k in range(2):
        p64 = snaps[k].astype(np.float64)
        v64 = vels[k].astype(np.float64)
        m64 = mass.astype(np.float64)
        ke = 0.5 * float(np.sum(m64 * np.sum(v64 * v64, axis=-1)))
        w = _potential_f64(p64, m64, eps2)
        np.testing.assert_allclose(res["energy"][k], ke + w, rtol=1e-12)
        np.testing.assert_allclose(res["virial"][k],
                                   virial_ratio(p64, v64, m64, eps2),
                                   rtol=1e-12)
    assert res["energy_drift"][0] == 0.0

    # Invariant drift series (validate's normalization, cli.py:427-444):
    # drift-from-first-snapshot over per-snapshot scale.
    m64 = mass.astype(np.float64)
    assert res["momentum_drift"][0] == 0.0
    assert res["ang_mom_drift"][0] == 0.0
    p0 = (m64[:, None] * vels[0].astype(np.float64)).sum(axis=0)
    p1 = (m64[:, None] * vels[1].astype(np.float64)).sum(axis=0)
    scale1 = float((m64 * np.linalg.norm(
        vels[1].astype(np.float64), axis=1)).sum())
    np.testing.assert_allclose(res["momentum_drift"][1],
                               np.abs(p1 - p0).max() / scale1, rtol=1e-12)
    from nbody_tpu.analysis import angular_momentum, center_of_mass
    l_drift = np.abs(
        angular_momentum(snaps[1].astype(np.float64),
                         vels[1].astype(np.float64), m64)
        - angular_momentum(snaps[0].astype(np.float64),
                           vels[0].astype(np.float64), m64)).max()
    # Mirror the momentum check: the series value must EQUAL the
    # independent computation (drift over snapshot-1's own scale,
    # L about each snapshot's own COM — advisor r4).
    c1 = center_of_mass(snaps[1].astype(np.float64), m64)
    l_scale1 = float((m64 * np.linalg.norm(
        snaps[1].astype(np.float64) - c1, axis=1) * np.linalg.norm(
        vels[1].astype(np.float64), axis=1)).sum())
    assert res["ang_mom_drift"][1] > 0
    np.testing.assert_allclose(res["ang_mom_drift"][1],
                               l_drift / l_scale1, rtol=1e-12)

    # Static pair -> drift exactly 0 at both snapshots.
    save_trajectory(path, np.stack([base, base]), snap_every=1, mass=mass,
                    vel_snapshots=np.stack([vel, vel]))
    res2 = analyze_trajectory(path, n_bins=8)
    assert res2["energy_drift"] == [0.0, 0.0]
    assert res2["momentum_drift"] == [0.0, 0.0]
    assert res2["ang_mom_drift"] == [0.0, 0.0]

    # Above the cap: energy series skipped with a note (not an O(N^2)
    # stall) — but the O(N) invariant series still computes.
    res3 = analyze_trajectory(path, n_bins=8, energy_max_n=64)
    assert "energy" not in res3 and "N=128" in res3["energy_note"]
    assert res3["momentum_drift"] == [0.0, 0.0]
    assert res3["ang_mom_drift"] == [0.0, 0.0]


def test_run_traj_vel_analyze_cli(tmp_path, capsys):
    """End-to-end product surface: `nbody run --traj-vel` (fused AND
    streamed capture branches) -> `nbody analyze` prints the dE/E0 and
    virial columns; leapfrog at small dt keeps |dE/E0| small."""
    from nbody_tpu.cli import main
    import json as _json
    # A mesh run takes the streamed TrajectoryWriter branch.
    for extra, name in (([], "fused.npz"),
                        (["--shards", "2", "--impl", "xla"],
                         "streamed.npz")):
        path = str(tmp_path / name)
        rc = main(["run", "--n", "64", "--steps", "6", "--impl", "xla_nxn",
                   "--dt", "0.001", "--snap-every", "2", "--quiet",
                   "--save-trajectory", path, "--traj-vel"] + extra)
        assert rc == 0
        capsys.readouterr()
        assert main(["analyze", path, "--json"]) == 0
        res = _json.loads(capsys.readouterr().out)
        assert len(res["energy"]) == 3 and len(res["virial"]) == 3
        assert max(res["energy_drift"]) < 1e-2
        # The exact invariants hold to rounding on a real integrator run
        # (kicks central, drifts along v — analysis.py docstring).  The
        # bound scales with accumulated f32 rounding (~steps * eps_f32
        # with headroom for backend/BLAS reduction-order variation;
        # advisor r4 — cli.py documents ~5e-5 after 1k steps).
        bound = 6 * 20 * np.finfo(np.float32).eps   # steps * 20*eps
        assert max(res["momentum_drift"]) < bound
        assert max(res["ang_mom_drift"]) < bound
        assert main(["analyze", path]) == 0
        out = capsys.readouterr().out
        assert "dE/E0" in out and "virial_Q" in out
        assert "dP_rel" in out and "dL_rel" in out
