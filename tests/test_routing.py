"""The one device-routing rule (ops/forces.py): which force path runs on
this device, and how compute_forces dispatches it.

The matrix below is a seeded sample of backend x N x dtype x integrator x
impl x sharding (the backend monkeypatched), each case checked against the
rule as written in this file — so any change to the rule shows up here.
"""

import itertools
import random

import jax
import jax.numpy as jnp
import pytest

from nbody_tpu import SimConfig
from nbody_tpu.ops import forces
from nbody_tpu.ops.forces import PALLAS_MIN_N, compute_forces, resolve_impl

BACKENDS = ("gpu", "cpu")
NS = (1, 512, PALLAS_MIN_N - 1, PALLAS_MIN_N, 4096, 4097, 8192, 1 << 20)
DTYPES = ("float32", "float64", "bfloat16")
INTEGRATORS = ("reference", "kdk", "yoshida4")
IMPLS = ("auto", "xla", "xla_nxn", "pallas")
SHARDED = (False, True)

_ALL = list(itertools.product(BACKENDS, NS, DTYPES, INTEGRATORS, IMPLS,
                              SHARDED))
MATRIX = random.Random(20261016).sample(_ALL, 96)


def _expected(backend, n, dtype, impl, sharded):
    if impl != "auto":
        return impl                        # an explicit choice is honored
    if backend == "gpu" and dtype == "float32" and n >= PALLAS_MIN_N:
        return "pallas"
    if n <= 4096 and not sharded:
        return "xla_nxn"
    return "xla"


@pytest.mark.parametrize(
    "backend,n,dtype,integrator,impl,sharded", MATRIX,
    ids=["-".join(map(str, case)) for case in MATRIX])
def test_routing_matrix(monkeypatch, backend, n, dtype, integrator, impl,
                        sharded):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = SimConfig(n_bodies=n, dtype=dtype, integrator=integrator,
                    impl=impl)
    assert resolve_impl(cfg, sharded=sharded) == _expected(
        backend, n, dtype, impl, sharded)


@pytest.mark.parametrize("backend,available", [("gpu", True), ("cpu", False),
                                               ("rocm", False)])
def test_kernel_available_only_on_gpu(monkeypatch, backend, available):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert forces.kernel_available() is available


def test_explicit_pallas_off_gpu_raises_instead_of_interpreting():
    """impl='pallas' on the CPU fails loudly: the kernel never falls back
    to the interpreter by itself."""
    cfg = SimConfig(n_bodies=64, impl="pallas")
    pos = jnp.zeros((64, 3), jnp.float32)
    with pytest.raises(RuntimeError, match="GPU only"):
        compute_forces(pos, jnp.ones((64,), jnp.float32), cfg)


def test_compute_forces_dispatches_pallas_to_the_kernel(monkeypatch):
    seen = {}

    def fake(pos, mass, eps2, block_i, block_j):
        seen.update(n=pos.shape[0], eps2=eps2, blocks=(block_i, block_j))
        return jnp.zeros_like(pos)

    from nbody_tpu.ops import forces_pallas
    monkeypatch.setattr(forces_pallas, "forces_pallas", fake)
    cfg = SimConfig(n_bodies=96, impl="pallas", block_i=16, block_j=64)
    compute_forces(jnp.zeros((96, 3)), jnp.ones((96,)), cfg)
    assert seen == {"n": 96, "eps2": cfg.eps2, "blocks": (16, 64)}


def test_xla_nxn_refuses_large_n():
    cfg = SimConfig(n_bodies=20000, impl="xla_nxn")
    with pytest.raises(ValueError, match="O\\(N\\^2\\)"):
        compute_forces(jnp.zeros((20000, 3)), jnp.ones((20000,)), cfg)


@pytest.mark.parametrize("impl", ["pallas_sym2", "pallas_turbo", "turbo",
                                  "resident"])
def test_removed_impls_are_rejected(impl):
    with pytest.raises(ValueError, match="impl must be one of"):
        SimConfig(impl=impl)


def test_ring_local_impl_uses_the_same_rule(monkeypatch):
    """The mesh ring resolves 'auto' through resolve_impl, as sharded."""
    from nbody_tpu.parallel.ring import _resolve_local_impl
    cfg = SimConfig(n_bodies=PALLAS_MIN_N)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _resolve_local_impl(cfg, None) == "pallas"
    assert _resolve_local_impl(cfg, "xla") == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert _resolve_local_impl(cfg, "auto") == "xla"
    assert _resolve_local_impl(cfg.replace(n_bodies=256), None) == "xla"
