"""Closed-form two-body (Kepler) analytic validation.

The reference validates only *differentially* — GPU vs an independently
written CPU oracle (``validation.cpp:55-103``).  A differential gate can
never catch an error shared by both sides (a wrong force law, a mis-stated
integrator).  This module adds the stronger gate the reference lacks:
comparison against *exact closed-form solutions* of the two-body problem
under the project's own force contract

    a_i = sum_j m_j * r_ij / (|r_ij|^2 + eps2)^{3/2}

(no G — absorbed into mass units, ``kernel.cu:9-29``).

Two families of exact solutions are used:

**Circular orbits (any eps2).**  Two bodies at separation ``d`` orbiting
their barycenter stay on exact circles even with Plummer softening: the
force magnitude on body 1 is ``m2*d/(d^2+eps2)^{3/2}`` and the circular
condition ``w^2 * r1 = |a_1|`` with ``r1 = d*m2/M`` gives

    w^2 = M_eff / (d^2 + eps2)^{3/2}

**The half-force subtlety.**  The reference integrator applies only *half*
the acceleration per step (``v += 0.5*DT*a; x += DT*v``,
``kernel.cu:116-124`` — SURVEY.md section 7 "Integration-scheme fidelity").
Its continuum limit is therefore ``x' = v, v' = a/2`` — symplectic Euler
for **half-force dynamics** — so the analytically-matched circular orbit
for ``integrator="reference"`` uses ``M_eff = M/2``, while ``"kdk"``
(true leapfrog) uses ``M_eff = M``.  That this module can state — and the
tests verify — the exact modified dynamics of the reference scheme is the
point of an analytic gate.

**Elliptic orbits (eps2 = 0).**  Standard Kepler propagation: eccentric
anomaly from Kepler's equation ``M_anom = E - e*sin(E)`` (Newton), relative
orbit ``(a*(cos E - e), a*sqrt(1-e^2)*sin E)``, bodies at ``-/+ (m_other/M)``
times the relative vector.  Gates the integrator's long-horizon behavior on
a non-trivial (eccentric) exactly-known trajectory.

Expected discretization orders (verified by ``tests/test_kepler.py``):
``kdk`` is second order (error ratio ~4 when dt halves); ``reference`` is
first order (~2) *against its own half-force analytic solution*.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import jax.numpy as jnp

from .state import SimState


def _dtype_of(name: str):
    return {"float32": jnp.float32, "float64": jnp.float64,
            "bfloat16": jnp.bfloat16}[name]


def circular_omega(d: float, m_total: float, eps2: float,
                   integrator: str = "kdk") -> float:
    """Angular velocity of the exact circular two-body orbit under the
    project force law — halved-force effective dynamics for the
    ``"reference"`` scheme (see module docstring)."""
    m_eff = m_total * (0.5 if integrator == "reference" else 1.0)
    return math.sqrt(m_eff / (d * d + eps2) ** 1.5)


def two_body_circular(d: float = 1.0, m1: float = 1.0, m2: float = 0.5,
                      eps2: float = 0.0, integrator: str = "kdk",
                      dtype: str = "float32") -> Tuple[SimState, float]:
    """Exact circular-orbit initial state.

    Bodies on the x-axis at barycentric radii ``r1 = d*m2/M`` (body 0, at
    -x) and ``r2 = d*m1/M`` (body 1, at +x), velocities tangent (+/-y) for
    angular velocity ``w = circular_omega(...)``.  Returns (state, w);
    period is ``2*pi/w``.
    """
    m = m1 + m2
    w = circular_omega(d, m, eps2, integrator)
    r1, r2 = d * m2 / m, d * m1 / m
    dt_ = _dtype_of(dtype)
    pos = jnp.asarray([[-r1, 0.0, 0.0], [r2, 0.0, 0.0]], dtype=dt_)
    vel = jnp.asarray([[0.0, -w * r1, 0.0], [0.0, w * r2, 0.0]], dtype=dt_)
    state = SimState(pos=pos, vel=vel, acc=jnp.zeros((2, 3), dt_),
                     mass=jnp.asarray([m1, m2], dtype=dt_))
    return state, w


def circular_positions(t: float, d: float = 1.0, m1: float = 1.0,
                       m2: float = 0.5, eps2: float = 0.0,
                       integrator: str = "kdk") -> np.ndarray:
    """Exact (2,3) float64 positions of the circular orbit at time t."""
    m = m1 + m2
    w = circular_omega(d, m, eps2, integrator)
    r1, r2 = d * m2 / m, d * m1 / m
    c, s = math.cos(w * t), math.sin(w * t)
    # Body 0 starts at angle pi (on -x), body 1 at angle 0.
    return np.array([[-r1 * c, -r1 * s, 0.0],
                     [r2 * c, r2 * s, 0.0]], dtype=np.float64)


def solve_kepler(m_anom: np.ndarray, e: float,
                 tol: float = 1e-14, max_iter: int = 64) -> np.ndarray:
    """Eccentric anomaly E from mean anomaly via Newton on
    ``E - e*sin(E) - M = 0`` (float64, vectorized)."""
    m_anom = np.asarray(m_anom, dtype=np.float64)
    ecc = np.where(e > 0.8, np.pi * np.ones_like(m_anom), m_anom)
    for _ in range(max_iter):
        f = ecc - e * np.sin(ecc) - m_anom
        ecc_next = ecc - f / (1.0 - e * np.cos(ecc))
        if np.max(np.abs(ecc_next - ecc)) < tol:
            return ecc_next
        ecc = ecc_next
    return ecc


def two_body_elliptic(a: float = 1.0, e: float = 0.5, m1: float = 1.0,
                      m2: float = 0.5,
                      dtype: str = "float32") -> Tuple[SimState, float]:
    """Exact elliptic-orbit initial state at perihelion (eps2 must be 0).

    Relative orbit: semi-major axis ``a``, eccentricity ``e``; perihelion
    separation ``a*(1-e)``, perihelion relative speed
    ``sqrt(M*(1+e)/(a*(1-e)))``.  Returns (state, period)."""
    m = m1 + m2
    rp = a * (1.0 - e)
    vp = math.sqrt(m * (1.0 + e) / rp)
    period = 2.0 * math.pi * math.sqrt(a ** 3 / m)
    dt_ = _dtype_of(dtype)
    # Bodies split the relative vector barycentrically (body 0 carries
    # -m2/M of it), so total momentum is zero and the barycenter is fixed.
    pos = jnp.asarray([[-rp * m2 / m, 0.0, 0.0],
                       [rp * m1 / m, 0.0, 0.0]], dtype=dt_)
    vel = jnp.asarray([[0.0, -vp * m2 / m, 0.0],
                       [0.0, vp * m1 / m, 0.0]], dtype=dt_)
    state = SimState(pos=pos, vel=vel, acc=jnp.zeros((2, 3), dt_),
                     mass=jnp.asarray([m1, m2], dtype=dt_))
    return state, period


def elliptic_positions(t: float, a: float = 1.0, e: float = 0.5,
                       m1: float = 1.0, m2: float = 0.5) -> np.ndarray:
    """Exact (2,3) float64 positions of the elliptic orbit at time t
    (perihelion at t=0, eps2=0)."""
    m = m1 + m2
    n = math.sqrt(m / a ** 3)          # mean motion
    ecc = float(solve_kepler(np.asarray(n * t), e))
    rx = a * (math.cos(ecc) - e)
    ry = a * math.sqrt(1.0 - e * e) * math.sin(ecc)
    rel = np.array([rx, ry, 0.0], dtype=np.float64)
    return np.stack([-rel * m2 / m, rel * m1 / m])


def max_rel_error(pos, ref: np.ndarray, scale: float) -> float:
    """max_i |pos_i - ref_i| / scale — position error relative to the
    orbit's size (``scale`` = separation d or semi-major axis a)."""
    err = np.linalg.norm(np.asarray(pos, dtype=np.float64) - ref, axis=1)
    return float(err.max() / scale)


def run_analytic_gates(impl: str = "auto", dtype: str = "float32",
                       steps_per_period: int = 2048,
                       block_i: "int | None" = None) -> "list[dict]":
    """Run the three closed-form gates through the PRODUCT step path
    (``ops.step.run_steps`` with the chosen backend), one period each.

    Gates:
      1. circular / integrator="reference" (half-force analytic target)
      2. circular / integrator="kdk"
      3. circular / integrator="yoshida4" (4th order)
      4. elliptic e=0.6 / integrator="kdk"
      5. elliptic e=0.6 / integrator="yoshida4"

    Returns one dict per gate with the measured max position error
    (relative to the orbit scale) and a pass/fail against a tolerance
    budgeted as ``C * (w*dt)^order + float-noise`` for that gate's scheme
    order (constants calibrated with ~8x margin over measured errors;
    see tests/test_kepler.py for the order verification itself).
    """
    from ..config import SimConfig
    from ..ops.step import prime_kdk, run_steps

    results = []
    d_scale, m1, m2, e = 1.0, 1.0, 0.5, 0.6
    noise = 5e-5 if dtype == "float32" else 1e-12

    def _cfg(integrator, dt, eps2):
        kw = {}
        if block_i:
            kw["block_i"] = block_i
        return SimConfig(n_bodies=2, dt=dt, eps2=eps2, impl=impl,
                         dtype=dtype, integrator=integrator, **kw)

    # -- Gate 1/2: circular, both integrators, softened (eps2 > 0 to also
    #    exercise the softening term of the closed form).
    # Calibrated coefficients (measured f64 @2048 steps/period, ~8x margin):
    # reference C1=0.031 (first order), kdk C2=1.3 (second order),
    # yoshida4 C4 measured 3.66 (fourth order; ratio exactly 16/dt-halving).
    eps2 = 0.01
    for integrator, order, c in (("reference", 1, 0.25), ("kdk", 2, 8.0),
                                 ("yoshida4", 4, 32.0)):
        state, w = two_body_circular(d_scale, m1, m2, eps2,
                                     integrator, dtype)
        period = 2.0 * math.pi / w
        dt = period / steps_per_period
        cfg = _cfg(integrator, dt, eps2)
        if integrator != "reference":
            state = prime_kdk(state, cfg)
        out = run_steps(state, cfg, steps_per_period)
        ref = circular_positions(period, d_scale, m1, m2, eps2, integrator)
        err = max_rel_error(out.pos, ref, d_scale)
        tol = c * (w * dt) ** order + noise
        results.append({"gate": f"circular/{integrator}", "steps":
                        steps_per_period, "max_rel_err": err, "tol": tol,
                        "ok": err <= tol})

    # -- Gates 4/5: elliptic e=0.6, near-unsoftened (Kepler closed form
    #    assumes eps2=0, but the kernels NEED eps2>0: the no-self-pair-guard
    #    contract (kernel.cu:17-27) makes the i==i term 0 via softening, and
    #    at eps2=0 it is rsqrt(0)*0 = NaN.  eps2=1e-10 perturbs the force by
    #    ~eps2/r^2 ~ 6e-10 relative — far below the discretization error.
    # Perihelion passage concentrates the error: budgets C_kdk = 600
    # (measured C ~ 91 at 2048 steps/period in f64; ~6.6x margin) and
    # C_yoshida4 measured ~1.25e3 (128-2048 spp sweep; ~8x margin).
    for integrator, order, c in (("kdk", 2, 600.0), ("yoshida4", 4, 1e4)):
        state, period = two_body_elliptic(d_scale, e, m1, m2, dtype)
        dt = period / steps_per_period
        cfg = _cfg(integrator, dt, 1e-10)
        state = prime_kdk(state, cfg)
        out = run_steps(state, cfg, steps_per_period)
        ref = elliptic_positions(period, d_scale, e, m1, m2)
        err = max_rel_error(out.pos, ref, d_scale)
        tol = c * (2.0 * math.pi / steps_per_period) ** order + noise
        results.append({"gate": f"elliptic(e=0.6)/{integrator}", "steps":
                        steps_per_period, "max_rel_err": err, "tol": tol,
                        "ok": err <= tol})
    return results
