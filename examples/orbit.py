#!/usr/bin/env python
"""Long-horizon orbital mechanics: the symplectic integrator showcase.

The reference's integrator (half-kick + drift, ``kernel.cu:116-124``)
is fine for its interactive demo but drifts secularly on orbits.  This
example runs a two-body Kepler system plus a small Plummer cluster for
100k steps under each integrator and prints the measured energy drift —
the 4th-order Yoshida composition holds orbits for millions of steps.
Each chunk of steps runs as one compiled program (``ops/step.py``), on
the tiled force kernel where ``impl=auto`` picks it (``ops/forces.py``).

Run:  python examples/orbit.py [N] [STEPS]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000

    import jax
    import nbody_tpu as nt
    from nbody_tpu.models.energy import energy_f64
    from nbody_tpu.models.init import plummer_virial_state
    from nbody_tpu.models.simulation import Simulation

    print(f"backend: {jax.default_backend()}, N={n}, steps={steps}")

    # A gravitationally bound cluster in virial equilibrium (velocities
    # sampled from the exact Plummer DF — a COLD sphere collapses
    # violently and would confound the integrator comparison).  dt is
    # chosen well under the cluster's central dynamical time.
    for integrator in ("reference", "yoshida4"):
        cfg = nt.SimConfig(n_bodies=n, integrator=integrator, dt=0.02,
                           eps2=1e6, seed=7)
        sim = Simulation(cfg, state=plummer_virial_state(cfg))
        e0 = energy_f64(sim.state, cfg.eps2)
        t0 = time.time()
        sim.run(n_steps=steps, log_every=0)
        wall = time.time() - t0
        e1 = energy_f64(sim.state, cfg.eps2)
        drift = abs(e1 - e0) / abs(e0)
        rate = n * n * steps / wall / 1e9
        print(f"{integrator:>10}: |dE/E| = {drift:.3e} over {steps} steps "
              f"({wall:.1f} s, {rate:.1f} GInter/s, impl={sim.impl})")


if __name__ == "__main__":
    main()
