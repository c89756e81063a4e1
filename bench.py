#!/usr/bin/env python
"""Benchmark entry point: prints ONE JSON line.

Headline config: N=1,048,576 on one device, impl=auto (the tiled kernel on
the GPU; ops/forces.py).  The headline is the MEDIAN of >=3 independent
trials of 10 steps each, with min/max spread and the device it ran on in the
JSON.  Environment overrides: ``NBODY_BENCH_N``, ``NBODY_BENCH_STEPS``,
``NBODY_BENCH_TRIALS``, ``NBODY_BENCH_IMPL``; nothing is shrunk or swapped
for the backend.
"""

import json
import os
import sys


def main() -> int:
    n = int(os.environ.get("NBODY_BENCH_N", "1048576"))
    steps = int(os.environ.get("NBODY_BENCH_STEPS", "10"))
    trials = int(os.environ.get("NBODY_BENCH_TRIALS", "3"))
    impl = os.environ.get("NBODY_BENCH_IMPL", "auto")

    from nbody_tpu.bench_lib import run_benchmark
    result = run_benchmark(n=n, steps=steps, impl=impl, trials=trials)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
