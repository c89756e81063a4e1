"""CI mirror of the integration hooks in ``__graft_entry__``, so the hooks
and the test suite cannot drift apart: the same code paths run here on the
8-virtual-device CPU mesh."""

import sys
import os

import conftest  # noqa: F401  (CPU backend, 8 virtual devices)

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import jax
import numpy as np


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    np.asarray(out.pos)
    assert out.pos.shape == args[0].pos.shape


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)   # even mesh (+ its internal 7-device submesh)


def test_dryrun_multichip_5():
    import __graft_entry__ as ge
    ge.dryrun_multichip(5)   # odd mesh (+ internal 4-device submesh)
