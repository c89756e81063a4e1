"""Benchmark harness library (used by ``bench.py`` and ``nbody bench``).

The reference ships no benchmark suite despite advertising one
(``README.md:15``; SURVEY.md section 6) — this module is the real thing.
Measures steady-state ms/step and GInteractions/s (interactions/step = N^2)
with compile excluded and completion forced by ``jax.block_until_ready``
(``utils/timing.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import numpy as np

from .config import SimConfig
from .models.energy import energy_f64
from .models.init import init_state
from .ops.forces import kernel_available, resolve_impl
from .ops.step import run_steps
from .utils.timing import sync


def auto_steps(n: int) -> int:
    """Trial length for ``steps=None``: ~0.5 s of device work at a nominal
    rate (1 TInter/s where the tiled kernel runs, 2 GInter/s elsewhere), so
    small-N trials measure the sweep rather than dispatch latency."""
    rate = 1e12 if kernel_available() else 2e9
    return int(min(8000, max(5, 0.5 * rate // max(1, n * n))))


def run_benchmark(n: int = 65536, steps: Optional[int] = None,
                  impl: str = "auto", block_i: Optional[int] = None,
                  block_j: Optional[int] = None, chunk: int = 1024,
                  shards: Optional[int] = None, comm: str = "ring",
                  energy: bool = False, warmup_steps: Optional[int] = None,
                  seed: int = 0, trials: int = 3) -> dict:
    from .utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    blocks = {k: v for k, v in (("block_i", block_i), ("block_j", block_j))
              if v is not None}
    cfg = SimConfig(n_bodies=n, impl=impl, chunk=chunk, seed=seed, **blocks)
    impl_resolved = resolve_impl(cfg, sharded=bool(shards and shards > 1))
    if steps is None:
        steps = auto_steps(n)

    compile_s = None   # AOT compile time (single-device path only)
    if shards and shards > 1:
        from jax.sharding import NamedSharding, PartitionSpec
        from .parallel.mesh import SHARD_AXIS, make_mesh
        from .parallel.ring import run_steps_sharded, shard_padding
        mesh = make_mesh(shards)
        # Born sharded when shards are tile-aligned.
        born = (NamedSharding(mesh, PartitionSpec(SHARD_AXIS))
                if shard_padding(cfg, shards) == n else None)
        state = init_state(cfg, sharding=born)

        def advance(s, k):
            return run_steps_sharded(s, cfg, mesh, k, impl=impl_resolved,
                                     comm=comm)
    else:
        state = init_state(cfg)
        # AOT-compile the timed program so compile time is reported apart
        # from the first execution.  The hasattr gate keeps stubbed
        # run_steps (tests) on the jit path.
        aot = None
        if hasattr(run_steps, "lower"):
            t0 = time.perf_counter()
            aot = run_steps.lower(state, cfg, steps,
                                  impl=impl_resolved).compile()
            compile_s = time.perf_counter() - t0

        def advance(s, k):
            if k == steps and aot is not None:
                return aot(s)
            return run_steps(s, cfg, k, impl=impl_resolved)

    e0 = energy_f64(state, cfg.eps2) if energy else None

    # Warmup (includes compile on the jit path).  Default: the SAME step
    # count as a timed trial, so warmup and trials share ONE program.
    if warmup_steps is None:
        warmup_steps = steps
    t0 = time.perf_counter()
    state = advance(state, max(1, warmup_steps))
    sync(state.pos)
    warmup_s = time.perf_counter() - t0

    # Timed region: >= `trials` independent trials of `steps` each; the
    # headline is the MEDIAN per-trial throughput, with the spread
    # reported alongside.
    per_trial = []
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        state = advance(state, steps)
        sync(state.pos)
        per_trial.append(time.perf_counter() - t0)
    # Headline = throughput of the median-TIME trial, so `value` and
    # `ms_per_step` always describe the same trial and n²·steps/time
    # round-trips exactly (independent medians of the two sorted lists
    # disagree for even trial counts).
    elapsed = float(np.sort(per_trial)[(len(per_trial) - 1) // 2])
    per_trial_g = sorted(n * n * steps / s / 1e9 for s in per_trial)
    ginter = n * n * steps / elapsed / 1e9

    e1 = energy_f64(state, cfg.eps2) if energy else None
    result = {
        "metric": "GInteractions/s",
        "value": round(ginter, 4),
        "unit": "GInter/s",
        "n_bodies": n,
        "steps": steps,
        "trials": len(per_trial),
        "impl": impl_resolved,
        "ms_per_step": round(elapsed / steps * 1000, 4),
        "ginter_min": round(per_trial_g[0], 4),
        "ginter_max": round(per_trial_g[-1], 4),
        "spread_pct": round(100.0 * (per_trial_g[-1] - per_trial_g[0])
                            / ginter, 2) if ginter else 0.0,
        "compile_s": (round(compile_s, 2)
                      if compile_s is not None else None),
        "warmup_s": round(warmup_s, 2),
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "devices": shards or 1,
    }
    if energy and e0 is not None:
        scale = abs(e0) or 1.0
        result["energy_drift"] = abs(e1 - e0) / scale
    finite = bool(np.all(np.isfinite(np.asarray(state.pos[:64]))))
    result["finite"] = finite
    return result
