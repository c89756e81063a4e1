"""bench.py and the benchmark library (nbody_tpu/bench_lib.py).

The reference ships no benchmark suite (README.md:15); bench.py is this
rebuild's.  It runs exactly what it is told: no retry, no shrinking N, no
swapping the impl for the backend.
"""

import json

import jax
import pytest

import bench
import nbody_tpu.bench_lib as bench_lib


def _fake_result(value=123.0, **kw):
    r = {"metric": "GInteractions/s", "value": value, "unit": "GInter/s",
         "ms_per_step": 1.0, "finite": True}
    r.update(kw)
    return r


def test_bench_runs_small_n_from_env(monkeypatch, capsys):
    """A real run at a small N passed through NBODY_BENCH_N, reporting the
    device it ran on."""
    monkeypatch.setenv("NBODY_BENCH_N", "256")
    monkeypatch.setenv("NBODY_BENCH_STEPS", "2")
    monkeypatch.setenv("NBODY_BENCH_TRIALS", "1")
    monkeypatch.setenv("NBODY_BENCH_IMPL", "xla")
    assert bench.main() == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_bodies"] == 256 and rec["steps"] == 2
    assert rec["impl"] == "xla" and rec["finite"]
    assert rec["backend"] == jax.default_backend()
    assert rec["device_kind"] == jax.devices()[0].device_kind
    assert "vs_baseline" not in rec


@pytest.mark.parametrize("n,impl", [(1048576, "auto"), (3000, "pallas"),
                                    (64, "xla_nxn")])
def test_bench_passes_n_and_impl_through(monkeypatch, capsys, n, impl):
    """bench.py never shrinks N or swaps the impl for the backend."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return _fake_result()

    monkeypatch.setattr(bench_lib, "run_benchmark", fake)
    monkeypatch.setenv("NBODY_BENCH_N", str(n))
    monkeypatch.setenv("NBODY_BENCH_IMPL", impl)
    assert bench.main() == 0
    assert seen["n"] == n and seen["impl"] == impl


def test_bench_does_not_retry(monkeypatch):
    """A failure surfaces at once: no second attempt hides it."""
    calls = []

    def flaky(**kw):
        calls.append(kw["impl"])
        raise RuntimeError("device failure")

    monkeypatch.setattr(bench_lib, "run_benchmark", flaky)
    with pytest.raises(RuntimeError, match="device failure"):
        bench.main()
    assert len(calls) == 1


def test_warmup_default_matches_steps(monkeypatch):
    """The compiled program embeds n_steps: the default warmup reuses the
    trials' step count so one executable serves both."""
    calls = []
    real = bench_lib.run_steps

    def spy(state, cfg, k, impl=None):
        calls.append(k)
        return real(state, cfg, k, impl=impl)

    monkeypatch.setattr(bench_lib, "run_steps", spy)
    bench_lib.run_benchmark(n=256, steps=4, impl="xla", trials=1)
    assert calls[0] == 4                  # warmup == steps (same program)
    assert all(k == 4 for k in calls)


def test_aot_compile_reported_apart(capsys):
    r = bench_lib.run_benchmark(n=128, steps=2, impl="xla_nxn", trials=1)
    assert r["compile_s"] is not None and r["compile_s"] >= 0
    assert r["warmup_s"] >= 0


def test_bench_auto_steps_scale_with_n(monkeypatch):
    """steps=None sizes trials by target DURATION so small-N runs measure
    the sweep, not dispatch latency."""
    seen = {}
    real = bench_lib.run_steps

    def spy(state, cfg, k, impl=None):
        seen.setdefault("k", k)
        return real(state, cfg, k, impl=impl)

    monkeypatch.setattr(bench_lib, "run_steps", spy)
    r = bench_lib.run_benchmark(n=256, steps=None, impl="xla", trials=1)
    assert r["steps"] == bench_lib.auto_steps(256) == 8000
    assert seen.get("k", r["steps"]) == r["steps"]


@pytest.mark.parametrize("backend,n,steps", [
    ("cpu", 256, 8000), ("cpu", 4096, 59), ("cpu", 1 << 20, 5),
    ("gpu", 8192, 7450), ("gpu", 65536, 116), ("gpu", 1 << 20, 5),
    ("gpu", 1024, 8000),
])
def test_auto_steps_table(monkeypatch, backend, n, steps):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert bench_lib.auto_steps(n) == steps


def test_cli_bench_steps_explicit_vs_auto(monkeypatch, capsys):
    """nbody bench forwards --steps only when the user passed it; unset
    means auto (None) so bench_lib scales the trial length."""
    import nbody_tpu.cli as cli
    got = {}

    def fake(n, steps, **kw):
        got["steps"] = steps
        return {"metric": "GInteractions/s", "value": 1.0, "finite": True}

    monkeypatch.setattr("nbody_tpu.bench_lib.run_benchmark", fake)
    cli.main(["bench", "--n", "512"])
    assert got["steps"] is None
    cli.main(["bench", "--n", "512", "--steps", "7"])
    assert got["steps"] == 7
