"""Runtime configuration for the N-body framework.

Replaces the reference's compile-time ``#define`` flag system
(``TestProject/constants.h:1-26``) with a runtime dataclass: the reference's
four behavior flags (REDUCTION/FLOAT_3/FADL/BLOCK_64) become the runtime
``impl`` / precision choices, and its numeric tuning constants
(THREADS_PER_BLOCK, TILE_WIDTH_FACTOR, N_BODIES) become the kernel block-size
knobs and ``n_bodies``.  Defaults match the reference's checked-in values:
DT=0.1, EPS2=0.002, N=8192, domain +/-1e5 per axis, mass in [1e5, 1e9]
(``constants.h:11-26``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

# Physics defaults — reference TestProject/constants.h:25-26
DEFAULT_DT = 0.1
DEFAULT_EPS2 = 0.002

# Domain / mass defaults — reference TestProject/constants.h:15-19
DEFAULT_MAX_POS = 100_000.0
DEFAULT_MIN_MASS = 100_000.0
DEFAULT_MAX_MASS = 1_000_000_000.0

# Workload default — reference TestProject/constants.h:13
DEFAULT_N_BODIES = 8192

# View box used by the visualizer — reference TestProject/constants.h:21-23
DEFAULT_MAX_VIEW = 200_000.0

# Tiled-kernel blocks, chosen by a block sweep on an H100 (PERF.md "Kernel
# block sweep"): the fastest shape at N=8,192, where a small block_i keeps
# enough programs in flight for 132 SMs.
DEFAULT_BLOCK_I = 32
DEFAULT_BLOCK_J = 64

VALID_IMPLS = ("auto", "xla", "xla_nxn", "pallas")
_VALID_INTEGRATORS = ("reference", "kdk", "yoshida4")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full runtime configuration of a simulation.

    Every knob the reference fixes at compile time is runtime-switchable here.
    """

    # Workload
    n_bodies: int = DEFAULT_N_BODIES
    steps: int = 100

    # Physics (reference constants.h:25-26)
    dt: float = DEFAULT_DT
    eps2: float = DEFAULT_EPS2

    # Initialization domain (reference constants.h:15-19, utils.cpp:30-37)
    max_pos: float = DEFAULT_MAX_POS
    min_mass: float = DEFAULT_MIN_MASS
    max_mass: float = DEFAULT_MAX_MASS
    seed: int = 0

    # Integration scheme. "reference" reproduces the reference's fused
    # half-kick + drift (kernel.cu:116-129) bit-for-bit in structure;
    # "kdk" is a textbook kick-drift-kick leapfrog offered as an upgrade;
    # "yoshida4" is a 4th-order symplectic composition of three KDK
    # sub-steps (3 force sweeps/step; models/integrators.py).
    integrator: str = "reference"

    # Force backend: "pallas" = the tiled GPU kernel (analog of the
    # reference's shared-memory tiled kernel family, kernel.cu:80-130);
    # "xla_nxn" = interaction-parallel broadcast+reduce path (analog of the
    # NxN reduction family, kernel.cu:163-469); "xla" = chunked scan
    # variant; "auto" picks by device, dtype and N (ops/forces.py).
    impl: str = "auto"

    # Precision of simulation state. fp32 matches the reference.
    dtype: str = "float32"

    # Tiled-kernel blocks (the analog of THREADS_PER_BLOCK /
    # TILE_WIDTH_FACTOR): bodies per program and per j-tile, powers of two.
    block_i: int = DEFAULT_BLOCK_I
    block_j: int = DEFAULT_BLOCK_J

    # Chunk size for the chunked-XLA force path.
    chunk: int = 1024

    # Visualization (reference simulation_visualization.h:8-9)
    viz: bool = False
    viz_width: int = 800
    viz_height: int = 600
    max_view: float = DEFAULT_MAX_VIEW
    viz_every: int = 1

    # Multi-device: number of mesh shards ("auto" = all local devices).
    shards: Optional[int] = None

    def __post_init__(self):
        if self.impl not in VALID_IMPLS:
            raise ValueError(
                f"impl must be one of {VALID_IMPLS}, got {self.impl!r}")
        if self.integrator not in _VALID_INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {_VALID_INTEGRATORS}, "
                f"got {self.integrator!r}")
        if self.n_bodies <= 0:
            raise ValueError("n_bodies must be positive")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def interactions_per_step(self) -> int:
        """All-pairs interaction count per step (N^2), the unit of the
        GInteractions/s throughput metric (sweep defined by kernel.cu:99-114)."""
        return self.n_bodies * self.n_bodies

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
