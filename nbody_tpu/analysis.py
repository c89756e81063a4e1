"""Trajectory analysis utilities.

The reference offers no post-hoc analysis at all — a run's physics dies
with the GL window (``main.cpp:361-366``).  These diagnostics operate on
the NPZ trajectory format (``io/checkpoint.py::save_trajectory``:
position snapshots + per-body masses) and on full states, giving the
rebuild a quantitative story for the same runs the reference can only
display: cluster structure (Lagrangian radii, pair correlation),
integration health (center-of-mass drift), and dynamical state (virial
ratio).

Conventions match the force/energy contract everywhere (G = 1, Plummer
softening: pair potential ``-m_i m_j / sqrt(|r|^2 + eps2)``,
``kernel.cu:9-29`` / ``models/energy.py``).  All computations are
host-side float64 numpy — these are offline diagnostics, not hot-path
device code, and f64 keeps them out of the noise they measure.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def center_of_mass(pos: np.ndarray, mass: np.ndarray) -> np.ndarray:
    """Mass-weighted mean position, (3,) float64."""
    pos = np.asarray(pos, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    return (mass[:, None] * pos).sum(axis=0) / mass.sum()


def com_drift(snapshots: np.ndarray, mass: np.ndarray) -> np.ndarray:
    """|COM(t) - COM(0)| per snapshot, (T,) float64.

    With the reference's cold start (v=0) total momentum is exactly zero,
    so any COM motion is integrator/rounding artifact — a cheap
    whole-trajectory health metric.  Accepts a (T, N, 3) array or any
    snapshot sequence (e.g. the streamed-NPZ ``LazySnapshots`` view) —
    snapshots are consumed one at a time.
    """
    coms = np.stack([center_of_mass(np.asarray(s, dtype=np.float64), mass)
                     for s in snapshots])
    return np.linalg.norm(coms - coms[0], axis=1)


def lagrangian_radii(pos: np.ndarray, mass: np.ndarray,
                     fractions: Sequence[float] = (0.1, 0.5, 0.9),
                     center: Optional[np.ndarray] = None) -> np.ndarray:
    """Radii enclosing the given mass fractions (about the COM by default).

    The 0.5 entry is the half-mass radius — the standard collapse /
    expansion indicator for the cold uniform boxes the reference
    initializes (``utils.cpp:23-47`` ranges).
    """
    pos = np.asarray(pos, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    c = center_of_mass(pos, mass) if center is None else np.asarray(center)
    r = np.linalg.norm(pos - c, axis=1)
    order = np.argsort(r)
    cum = np.cumsum(mass[order])
    total = cum[-1]
    out = np.empty(len(fractions), dtype=np.float64)
    for k, f in enumerate(fractions):
        idx = int(np.searchsorted(cum, f * total))
        out[k] = r[order[min(idx, len(r) - 1)]]
    return out


def pair_correlation(pos: np.ndarray, n_bins: int = 64,
                     r_max: Optional[float] = None,
                     chunk: int = 2048,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Radial pair-correlation function g(r) of a finite cloud.

    Normalization: the pair-distance histogram is divided by the expected
    histogram of bodies distributed uniformly in the enclosing sphere
    (computed analytically from the uniform-sphere pair-distance
    density), then rescaled so both histograms carry the same total pair
    count within ``r_max`` — making g a *shape* diagnostic that is
    insensitive to the enclosing-radius estimate (the sample max radius
    is biased by the COM offset).  g ~ 1 then means "uniform"; g > 1,
    clustering at that separation.  ``r_max`` defaults to the enclosing
    radius.  O(N^2) pair distances, chunked to bound the temporary at
    ``chunk * N`` float64s (distances come from the norm expansion
    ``|a|^2 + |b|^2 - 2 a.b`` — exact enough in f64 at domain scale, and
    8x leaner than materializing the (chunk, N, 3) difference tensor,
    which was ~3 GB at N=65536).

    Returns ``(r_centers, g)``, each (n_bins,).
    """
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if n < 2:
        raise ValueError("pair_correlation needs at least 2 bodies")
    c = pos.mean(axis=0)
    radii = np.linalg.norm(pos - c, axis=1)
    enclosing = float(radii.max()) or 1.0
    if r_max is None:
        r_max = enclosing
    edges = np.linspace(0.0, r_max, n_bins + 1)
    hist = np.zeros(n_bins, dtype=np.float64)
    norms = np.sum(pos * pos, axis=1)              # (N,) |x|^2
    for s in range(0, n, chunk):
        pc = pos[s:s + chunk]
        d2 = norms[s:s + chunk, None] + norms[None, :] - 2.0 * (pc @ pos.T)
        d = np.sqrt(np.maximum(d2, 0.0))           # (chunk, N)
        # Upper triangle only: each unordered pair once, no self-pairs.
        jj = np.arange(n)[None, :]
        ii = (s + np.arange(pc.shape[0]))[:, None]
        d = d[jj > ii]
        hist += np.histogram(d, bins=edges)[0]
    # Uniform-sphere (radius R) pair-distance distribution: with x = s/R
    # in [0, 2] the separation PDF is p(s) = (3 s^2 / R^3)(1 - 3s/(4R)
    # + s^3/(16 R^3)), whose CDF is P(x) = x^3 (32 - 18x + x^3) / 32
    # (P(2) = 1).
    x = np.clip(edges / enclosing, 0.0, 2.0)
    cdf = np.clip(x ** 3 * (32.0 - 18.0 * x + x ** 3) / 32.0, 0.0, 1.0)
    expected = np.diff(cdf)
    if expected.sum() > 0:
        expected *= hist.sum() / expected.sum()
    centers = 0.5 * (edges[:-1] + edges[1:])
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(expected > 0, hist / expected, 0.0)
    return centers, g


def angular_momentum(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                     center: Optional[np.ndarray] = None) -> np.ndarray:
    """Total angular momentum L = sum_i m_i (r_i - c) x v_i, (3,) float64,
    about the COM by default.

    The softened pairwise force is central (along r_ij), so L is exactly
    conserved by the continuous dynamics from ANY start; under the
    symplectic integrators the numeric drift stays at rounding scale —
    a conservation diagnostic orthogonal to energy (which leapfrog only
    bounds) and momentum (trivially zero from the cold start)."""
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    c = center_of_mass(pos, mass) if center is None else np.asarray(center)
    return (mass[:, None] * np.cross(pos - c, vel)).sum(axis=0)


def virial_ratio(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                 eps2: float) -> float:
    """Q = 2K / |W| with the softened potential (Q = 1 in virial
    equilibrium; 0 for the reference's cold start)."""
    vel = np.asarray(vel, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    ke = 0.5 * float(np.sum(mass * np.sum(vel * vel, axis=-1)))
    w = _potential_f64(np.asarray(pos, dtype=np.float64), mass, eps2)
    return 2.0 * ke / abs(w) if w else float("inf")


def _potential_f64(pos: np.ndarray, mass: np.ndarray, eps2: float,
                   chunk: int = 2048) -> float:
    pe = 0.0
    n = pos.shape[0]
    for s in range(0, n, chunk):
        pc = pos[s:s + chunk]
        mc = mass[s:s + chunk]
        r = pos[None, :, :] - pc[:, None, :]
        d2 = np.sum(r * r, axis=-1) + eps2
        with np.errstate(divide="ignore"):
            inv = 1.0 / np.sqrt(d2)
        # Mask self-pairs in place (works at eps2 = 0 too, where the
        # subtract-after trick would hit 1/0).
        rows = np.arange(pc.shape[0])
        inv[rows, s + rows] = 0.0
        pe += float(np.sum(mc[:, None] * mass[None, :] * inv))
    return -0.5 * pe


def analyze_trajectory(path: str, n_bins: int = 32,
                       fractions: Sequence[float] = (0.1, 0.5, 0.9),
                       eps2: Optional[float] = None,
                       energy_max_n: int = 16384) -> dict:
    """Per-snapshot structure series from a saved trajectory NPZ.

    Returns a dict with ``steps`` (snapshot step numbers), ``com_drift``,
    ``lagrangian_radii`` (T, len(fractions)), and the first/last
    snapshots' pair correlation (``g_r_first`` / ``g_r_last`` with
    ``r_centers`` on a shared grid).

    When the trajectory carries velocities (``nbody run --traj-vel`` /
    ``run_trajectory(..., with_vel=True)``) it also returns the
    integration-health and dynamical-state series positions alone cannot
    carry: ``energy`` (total, f64), ``energy_drift``
    (|E(t) - E(t0)| / |E(t0)| relative to the FIRST SNAPSHOT — snapshots
    start at step ``snap_every``, not 0) and ``virial`` (Q = 2K/|W|),
    plus the exactly-conserved invariants as drift series (same
    normalization as ``nbody validate``'s invariant gate,
    ``cli.py:427-444``): ``momentum_drift`` =
    max|P(t) - P(t0)| / (sum m|v| or 1) and ``ang_mom_drift`` =
    max|L(t) - L(t0)| / (sum m|r - c||v| or 1) with L about each
    snapshot's COM.  Unlike energy (which leapfrog only bounds and chaos
    blurs), these are exact invariants of every integrator here — kicks
    are central (zero torque) and drifts move along v — so sustained
    growth in either series indicates an implementation bug, not
    physics.  O(N) per snapshot, so they are computed even when the
    O(N^2) energy sweep is skipped.
    ``eps2`` defaults to the trajectory's embedded config (falling back
    to the ``constants.h`` default).  The potential sweep is O(N^2)
    host f64 per snapshot, so the energy/virial series is skipped above
    ``energy_max_n`` bodies with an ``energy_note`` saying so (device-
    side bounded energy exists for huge states — ``models/energy.py`` —
    but operates on live states, not host snapshot streams).
    """
    from .io.checkpoint import load_trajectory_full
    snaps, vels, mass, snap_every, cfg = load_trajectory_full(path)
    if mass is None:   # legacy trajectory without masses: uniform weights
        mass = np.ones(snaps.shape[1], dtype=np.float64)
    else:
        mass = np.asarray(mass, dtype=np.float64)
    t = snaps.shape[0]
    # Snapshots consumed ONE at a time (streamed trajectories load
    # lazily; peak memory stays O(one snapshot) at any T).
    lr = np.stack([lagrangian_radii(snaps[k], mass, fractions)
                   for k in range(t)])
    # Shared r grid across first/last so the two curves are comparable.
    first = np.asarray(snaps[0], dtype=np.float64)
    last = np.asarray(snaps[t - 1], dtype=np.float64)
    c0 = first.mean(axis=0)
    r_max = float(np.linalg.norm(first - c0, axis=1).max())
    r_centers, g_first = pair_correlation(first, n_bins, r_max=r_max)
    _, g_last = pair_correlation(last, n_bins, r_max=r_max)
    out = {
        "steps": [(k + 1) * snap_every for k in range(t)],
        "fractions": list(fractions),
        "com_drift": com_drift(snaps, mass).tolist(),
        "lagrangian_radii": lr.tolist(),
        "r_centers": r_centers.tolist(),
        "g_r_first": g_first.tolist(),
        "g_r_last": g_last.tolist(),
    }
    if vels is not None:
        if eps2 is None:
            if cfg is not None:
                eps2 = cfg.eps2
            else:
                from .config import SimConfig
                eps2 = SimConfig().eps2   # constants.h:19 default
        n = snaps.shape[1]
        do_energy = n <= energy_max_n
        energy, virial = [], []
        moms, p_scales, angs, l_scales = [], [], [], []
        for k in range(t):
            p = np.asarray(snaps[k], dtype=np.float64)
            v = np.asarray(vels[k], dtype=np.float64)
            speed = np.linalg.norm(v, axis=1)
            moms.append((mass[:, None] * v).sum(axis=0))
            p_scales.append(float((mass * speed).sum()))
            c = center_of_mass(p, mass)
            angs.append(angular_momentum(p, v, mass, center=c))
            l_scales.append(float(
                (mass * np.linalg.norm(p - c, axis=1) * speed).sum()))
            if do_energy:
                ke = 0.5 * float(np.sum(mass * speed * speed))
                w = _potential_f64(p, mass, eps2)
                energy.append(ke + w)
                virial.append(2.0 * ke / abs(w) if w else float("inf"))
        out["momentum_drift"] = [
            float(np.abs(moms[k] - moms[0]).max()) / (p_scales[k] or 1.0)
            for k in range(t)]
        out["ang_mom_drift"] = [
            float(np.abs(angs[k] - angs[0]).max()) / (l_scales[k] or 1.0)
            for k in range(t)]
        if do_energy:
            e0 = energy[0]
            out["energy"] = energy
            out["energy_drift"] = [abs(e - e0) / (abs(e0) or 1.0)
                                   for e in energy]
            out["virial"] = virial
            out["eps2"] = float(eps2)
        else:
            out["energy_note"] = (
                f"N={n} > energy_max_n={energy_max_n}: the O(N^2) host-f64 "
                f"potential sweep is skipped (pass a larger energy_max_n "
                f"to force it)")
    return out
