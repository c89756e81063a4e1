#!/usr/bin/env python
"""Smoke test on the GPU: drive the main path once, at real sizes, in ONE
process (a second JAX process on the same card would find its memory
reserved).

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the mesh phase only

Phases (any failure raises, and the script exits non-zero):

1. device: the default backend must be the GPU; prints the card's name and
   power limit as nvidia-smi reports them.
2. kernel gate: the tiled force kernel, compiled for the card (never the
   interpreter), against the float64 NumPy oracle at N=8,192 and N=8,191
   (padding), and at N=1,048,576 on 1,024 sampled rows against all j; all
   rows at 1,048,576 against XLA's chunked path.  Gate: no component
   outside 1% (``relative_mismatch``) against the oracle, for the kernel
   and for the chunked path.  On the full 1M sweep the two paths may part
   by more than 1% on at most 64 rows (near-cancelling components), and
   the oracle holds the kernel on each such row to 1% or to the
   probabilistic float32 error of its summation order.
3. main path through ``nbody_tpu.cli.main``: ``run`` at N=1,048,576 with
   energy, ``run`` at the reference's interactive design point (N=8,192, a
   frame every step), and ``validate`` at N=8,192 (10-step strict gate).
4. times, for information: median of 3 trials of ms/step and GInter/s,
   kernel against XLA, at N=8,192 and N=1,048,576, compile time apart;
   then the same pairs through ``nbody run``.

With ``--devices 4``: ``run --shards 4`` with the ring and with the
all-gather at N=1,048,576 for 2 steps, each compared with the one-card run
from the same initial state.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
EPS2 = 0.002
BIG_N = 1_048_576
REF_N = 8192
# Rows of the N=1M sweep on which the kernel and XLA's chunked path may part
# by more than 1% (near-cancelling components; 20 seen on an H100).
SPLIT_CAP = 64

PRECISION = ("precision: float32 state; the kernel's float32 pair terms and "
             "plain float32 sums (no matrix units); XLA's chunked path sums "
             "the same float32 terms in the direct form (no dot, no TF32)")


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")
    print(f"[OK] {what}", flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


def system(n: int, seed: int):
    r = np.random.default_rng(seed)
    pos = r.uniform(-1e5, 1e5, size=(n, 3)).astype(np.float32)
    mass = r.uniform(1e5, 1e9, size=(n,)).astype(np.float32)
    return pos, mass


def mismatch(got, want):
    """(fraction outside 1%, p99 relative error) of got against want."""
    from nbody_tpu.oracle.numpy_oracle import relative_mismatch
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bad = float(relative_mismatch(got, want, 0.01, 1e-6).mean())
    rel = np.abs(got - want) / (np.abs(want) + 1e-30)
    return bad, float(np.percentile(rel, 99))


def oracle_row(pos, mass, i):
    """(a_i, sum_j |a_ij|) of body i against all j, in float64, per
    component: the f64 answer and the scale of its terms."""
    p = pos.astype(np.float64)
    r = p - p[i]
    d2 = np.sum(r * r, axis=1) + EPS2
    f = mass.astype(np.float64) / np.sqrt(d2 * d2 * d2)
    f[i] = 0.0
    terms = f[:, None] * r
    return terms.sum(axis=0), np.abs(terms).sum(axis=0)


def run_cli(argv):
    """nbody_tpu.cli.main in this process; returns (rc, captured stdout),
    echoing the output."""
    from nbody_tpu.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    print(buf.getvalue(), end="", flush=True)
    return rc, buf.getvalue()


def load_state(path):
    from nbody_tpu.io.checkpoint import load_checkpoint
    state, step, _ = load_checkpoint(path)
    return {k: np.asarray(getattr(state, k)) for k in ("pos", "vel", "acc")}


def phase_kernel_gate():
    import jax
    import jax.numpy as jnp
    from nbody_tpu import SimConfig, init_state, run_steps
    from nbody_tpu.ops.forces_pallas import forces_pallas
    from nbody_tpu.ops.forces_xla import forces_chunked
    from nbody_tpu.oracle.numpy_oracle import oracle_forces

    print(PRECISION, flush=True)
    kernel = jax.jit(lambda p, m: forces_pallas(p, m, EPS2))
    chunked = jax.jit(lambda p, m: forces_chunked(p, m, EPS2))
    for n in (REF_N, REF_N - 1):
        pos, mass = system(n, seed=n)
        p, m = jnp.asarray(pos), jnp.asarray(mass)
        if n == REF_N:
            compiled = kernel.lower(p, m).compile()
            print(f"kernel memory_analysis N={n}: "
                  f"{compiled.memory_analysis()}", flush=True)
            cfg = SimConfig(n_bodies=n)
            step = run_steps.lower(init_state(cfg), cfg, 1,
                                   impl="pallas").compile()
            print(f"step memory_analysis N={n}: "
                  f"{step.memory_analysis()}", flush=True)
        ref = oracle_forces(pos, mass, EPS2)
        for name, fn in (("kernel", kernel), ("xla chunked", chunked)):
            bad, p99 = mismatch(fn(p, m), ref)
            print(f"{name} vs f64 oracle N={n}: mismatch={bad} p99={p99:.3e}")
            gate(bad == 0.0, f"{name} N={n} 1% mismatch fraction is 0")

    pos, mass = system(BIG_N, seed=1)
    p, m = jnp.asarray(pos), jnp.asarray(mass)
    acc_k = np.asarray(kernel(p, m))
    acc_c = np.asarray(chunked(p, m))
    gate(bool(np.all(np.isfinite(acc_k))), f"kernel N={BIG_N} finite")
    rows = np.random.default_rng(2).choice(BIG_N, size=1024, replace=False)
    t0 = time.perf_counter()
    ref = oracle_forces(pos, mass, EPS2, rows=rows)
    print(f"f64 oracle on {rows.size} rows x {BIG_N}: "
          f"{time.perf_counter() - t0:.1f} s host", flush=True)
    for name, acc in (("kernel", acc_k), ("xla chunked", acc_c)):
        bad, p99 = mismatch(acc[rows], ref)
        print(f"{name} vs f64 oracle N={BIG_N} (1024 rows): mismatch={bad} "
              f"p99={p99:.3e}")
        gate(bad == 0.0, f"{name} N={BIG_N} sampled-row 1% mismatch is 0")
    # All rows, the two float32 paths against each other.  This replaces a
    # strict "no component outside 1%" gate between them, which two float32
    # summation orders cannot meet at this N: a component whose terms
    # nearly cancel (a force almost along another axis) carries rounding of
    # order u * sum_j |a_ij| in both sums, which can exceed 1% of what is
    # left.  So at most SPLIT_CAP rows may part by more than 1%, and the
    # f64 oracle decides each: the kernel must be within 1% of it, or within
    # the probabilistic float32 error of its summation order (each of
    # block_j lanes sums N/block_j terms in sequence, then a tree over the
    # lanes): sqrt(N/block_j + log2(block_j)) * u * sum_j |a_ij|.
    from nbody_tpu.config import DEFAULT_BLOCK_J
    from nbody_tpu.oracle.numpy_oracle import relative_mismatch
    raw, p99 = mismatch(acc_k, acc_c)
    print(f"kernel vs xla chunked N={BIG_N} (all rows): mismatch={raw} "
          f"p99={p99:.3e}", flush=True)
    split = np.flatnonzero(relative_mismatch(acc_k, acc_c, 0.01, 1e-6)
                           .any(axis=1))
    gate(split.size <= SPLIT_CAP,
         f"{split.size} rows (at most {SPLIT_CAP}) where the two float32 "
         f"paths part by >1%")
    gamma = (np.sqrt(BIG_N / DEFAULT_BLOCK_J + np.log2(DEFAULT_BLOCK_J))
             * 2.0 ** -24)
    for i in split:
        want, scale = oracle_row(pos, mass, int(i))
        err_k = np.abs(acc_k[i] - want)
        err_c = np.abs(acc_c[i] - want)
        ok = bool(np.all(err_k <= 0.01 * np.abs(want) + gamma * scale))
        print(f"  row {i}: oracle {want} sum|a_ij| {scale} | kernel err "
              f"{err_k} xla err {err_c} -> "
              f"{'within' if ok else 'OUTSIDE'} 1% + {gamma:.2e} sum|a_ij|")
        gate(ok, f"kernel row {i} against the f64 oracle")
    gate(True, f"kernel vs xla chunked N={BIG_N}: every 1% split is within "
               f"the float32 bound of the f64 oracle")


def phase_main_path(work: Path):
    ck = str(work / "big.npz")
    rc, out = run_cli(["run", "--n", str(BIG_N), "--steps", "3", "--energy",
                       "--checkpoint", ck])
    gate(rc == 0 and "energy drift" in out,
         f"run --n {BIG_N} --steps 3 --energy printed the energy drift")
    st = load_state(ck)
    gate(all(np.all(np.isfinite(v)) for v in st.values())
         and st["pos"].shape == (BIG_N, 3), f"N={BIG_N} final state finite")

    frames = work / "frames"
    ck = str(work / "viz.npz")
    rc, _ = run_cli(["run", "--n", str(REF_N), "--steps", "20", "--viz",
                     "--viz-every", "1", "--viz-dir", str(frames),
                     "--checkpoint", ck])
    n_frames = len(list(frames.glob("*.png")))
    gate(rc == 0 and n_frames == 20, f"run --viz wrote {n_frames} frames")
    st = load_state(ck)
    gate(all(np.all(np.isfinite(v)) for v in st.values()),
         f"N={REF_N} final state finite")

    rc, out = run_cli(["validate", "--n", str(REF_N), "--long-steps", "0"])
    gate(rc == 0 and "Verification PASSED" in out,
         f"validate --n {REF_N} (10 steps, strict 1% gate)")


def phase_times(card: str):
    from nbody_tpu.bench_lib import run_benchmark
    for n, steps in ((REF_N, 500), (BIG_N, 1)):
        for impl in ("pallas", "xla"):
            r = run_benchmark(n=n, steps=steps, impl=impl, trials=3)
            gate(r["finite"], f"times {impl} N={n} finite")
            print(f"time {impl} N={n}: {r['ms_per_step']} ms/step "
                  f"{r['value']} GInter/s (median of {r['trials']}, "
                  f"min {r['ginter_min']} max {r['ginter_max']}) compile "
                  f"{r['compile_s']} s, first run {r['warmup_s']} s "
                  f"[{card}]", flush=True)
    # The same comparison through `nbody run` (Simulation): the first,
    # compile-inclusive chunk is left out of its ms/step.
    for n, steps, every in ((REF_N, 300, 100), (BIG_N, 3, 1)):
        for impl in ("pallas", "xla"):
            rc, _ = run_cli(["run", "--n", str(n), "--steps", str(steps),
                             "--log-every", str(every), "--impl", impl])
            gate(rc == 0, f"nbody run --impl {impl} N={n} [{card}]")


def phase_mesh(work: Path, n_dev: int):
    """The ring and the all-gather on n_dev cards against one card, from
    the same initial state (the seeded uniform init), after 2 steps.

    Tolerance: the shards add their partial sums in another order than one
    card does.  A single sweep already parts two float32 orders by more
    than 1% on ~1e-5 of the components (phase 2: 20 rows of 1M, each
    within float32's bound of the f64 oracle), and a close pair turns such
    a difference into a large one in pos and vel within a step.  So: no
    non-finite value, and at most 1e-4 of the components of pos, vel and
    acc outside 1% of the one-card run (``relative_mismatch``)."""
    import jax
    gate(len(jax.devices()) >= n_dev, f"{n_dev} devices present")
    base = ["run", "--n", str(BIG_N), "--steps", "2"]
    ck1 = str(work / "one.npz")
    rc, _ = run_cli(base + ["--checkpoint", ck1])
    gate(rc == 0, "one-card run")
    one = load_state(ck1)
    for comm in ("ring", "allgather"):
        ck = str(work / f"{comm}.npz")
        rc, _ = run_cli(base + ["--shards", str(n_dev), "--comm", comm,
                                "--checkpoint", ck])
        gate(rc == 0, f"run --shards {n_dev} --comm {comm}")
        got = load_state(ck)
        gate(all(np.all(np.isfinite(v)) for v in got.values()),
             f"{comm} x{n_dev} final state finite")
        worst = 0.0
        for k in ("pos", "vel", "acc"):
            bad, p99 = mismatch(got[k], one[k])
            d = float(np.abs(got[k] - one[k]).max())
            print(f"{comm} x{n_dev} vs one card {k}: outside 1% {bad:.3e} "
                  f"p99 rel {p99:.3e} max|diff| {d:.3e}", flush=True)
            worst = max(worst, bad)
        gate(worst <= 1e-4, f"{comm} x{n_dev} agrees with one card "
                            f"(worst fraction outside 1%: {worst:.3e})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="run only the mesh phase on this many cards")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r}); nothing was run",
              file=sys.stderr)
        return 1
    import nbody_tpu  # noqa: F401  (fails outside a checkout of the repo)

    card = card_info()
    print(card, flush=True)
    d = jax.devices()[0]
    print(f"jax: {d.platform} {d.device_kind} x{len(jax.devices())}",
          flush=True)
    count = len(jax.devices())
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke-") as tmp:
        work = Path(tmp)
        if args.devices:
            phase_mesh(work, args.devices)
            count = args.devices
        else:
            t0 = time.perf_counter()
            phase_kernel_gate()
            phase_main_path(work)
            phase_times(card.splitlines()[0])
            print(f"chip_smoke phases took {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    os.chdir(HERE)
    sys.exit(main())
