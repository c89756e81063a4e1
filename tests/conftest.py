"""Test configuration: the CPU backend with 8 virtual devices (unless
``JAX_PLATFORMS`` names another platform), so the multi-device `shard_map`
ring path is exercised without a GPU cluster (SURVEY.md section 4
'Implication for the rebuild').  Must run before jax is imported.

Tests of what runs only on the card carry the ``gpu`` marker and skip
unless JAX's default backend is the GPU (decided in a fixture, never at
import).  On the card: ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``;
``python chip_smoke.py`` covers the same ground end to end.

Tests of paths that call the tiled kernel take the ``kernel_interpret``
fixture, which runs the kernel in the Pallas interpreter on the CPU.

Collective-timing envelope
--------------------------
XLA's CPU collective runtime HARD-TERMINATES the whole process (SIGABRT,
``rendezvous.cc`` "Termination timeout") when any participant of a
collective arrives more than ~40 s after the first.  On a 1-core host all
8 virtual devices serialize, so a mesh test whose per-device work between
two collectives exceeds ~40/8 = 5 s of single-core compute can abort the
ENTIRE pytest run.

Rules for new mesh tests:
- Keep executed geometry tiny: <= ~128 bodies/device for the
  interpret-mode kernel, 1-2 steps.  Plan/arithmetic assertions may use any
  geometry — only EXECUTION counts against the envelope.
- Prefer many small bounded programs (each ends with its own rendezvous)
  over one fused program with long compute between ppermutes.
- The ``pytest_runtest_logreport`` hook below enforces a per-test wall
  budget as a lint: a test above TEST_BUDGET_S fails the session even if
  it passed, because it is one slow-host factor away from a process
  abort.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Per-test wall budget (seconds): headroom for slower hosts while still
# catching a minutes-long mesh geometry before it aborts the suite.
TEST_BUDGET_S = 240.0
_over_budget = []


def pytest_runtest_logreport(report):
    if report.when == "call" and report.duration > TEST_BUDGET_S:
        _over_budget.append((report.nodeid, report.duration))


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    if _over_budget:
        terminalreporter.section("collective-timing envelope (conftest.py)")
        for nid, dur in _over_budget:
            terminalreporter.write_line(
                f"BUDGET EXCEEDED: {nid} took {dur:.0f}s "
                f"(> {TEST_BUDGET_S:.0f}s) — shrink its executed mesh "
                f"geometry before it SIGABRTs the suite on a slow host")


def pytest_sessionfinish(session, exitstatus):
    if _over_budget and session.exitstatus == 0:
        session.exitstatus = 1


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless the default backend is the GPU."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip(f"needs the GPU (backend is {jax.default_backend()!r}); "
                    "chip_smoke.py covers it on the card")


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Run every call of the tiled kernel in the Pallas interpreter, so
    paths that dispatch impl='pallas' (step, Simulation, the mesh ring)
    run on the CPU."""
    from nbody_tpu.ops import forces_pallas
    compiled = forces_pallas.rect_forces_pallas

    def interpreted(*args, **kwargs):
        return compiled(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(forces_pallas, "rect_forces_pallas", interpreted)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_small_system(n=256, seed=0, dtype=np.float32,
                      max_pos=100_000.0, min_mass=1e5, max_mass=1e9):
    """Small random system in the reference's init ranges (utils.cpp:30-37)."""
    r = np.random.default_rng(seed)
    pos = r.uniform(-max_pos, max_pos, size=(n, 3)).astype(dtype)
    mass = r.uniform(min_mass, max_mass, size=(n,)).astype(dtype)
    vel = np.zeros((n, 3), dtype=dtype)
    return pos, vel, mass
