"""nbody_tpu — an all-pairs N-body simulation framework in JAX.

A JAX/XLA/Pallas rebuild of the capabilities of the CUDA reference
``LienoPC/N-BodySimulation`` (see SURVEY.md for the full component map):
softened all-pairs Newtonian gravity, fused leapfrog-style integration, two
independent device force backends (the tiled Pallas kernel, compiled through
Triton for the GPU, and XLA's interaction-parallel paths), a CPU validation
oracle, headless visualization, checkpointing, structured logging,
benchmarking, and ring sharding over a device mesh.
"""

from .config import SimConfig
from .models.init import init_state, plummer_state
from .models.state import SimState, pad_state, unpad_state
from .ops.forces import compute_forces, resolve_impl
from .ops.step import prime_kdk, run_steps, run_trajectory, step

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "SimState", "init_state", "plummer_state",
    "pad_state", "unpad_state", "compute_forces", "resolve_impl",
    "step", "run_steps", "run_trajectory",
    "prime_kdk", "__version__",
]
