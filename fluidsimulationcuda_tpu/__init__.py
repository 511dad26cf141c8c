"""fluidsimulationcuda_tpu — a stable-fluids simulation framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
ArbiterMob/FluidSimulationCuda (Jos Stam's *Stable Fluids* solver plus a
comparative parallelization study).  The reference's 19 standalone CUDA/C
programs collapse here into one engine:

- ``core``      — ``SimConfig`` / ``FluidState`` pytrees (reference L0 + config)
- ``oracle``    — NumPy ground-truth transcription of the sequential solver
- ``ops``       — the five core operators in pure jnp (reference backend)
- ``kernels``   — backend dispatch and the fused CUDA Jacobi kernel (Hopper)
- ``models``    — step composition: 2-D flagship, batched datagen, 3-D smoke
- ``parallel``  — multi-device spatial decomposition (shard_map + halo exchange)
- ``utils``     — timing, checkpointing, profiling
"""

from .core.config import SimConfig
from .core.state import FluidState, Sources, reference_init, zero_sources, zero_state
from .models.stable_fluids_2d import StableFluids2D, make_step_fn, simulate, step, step_audited

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "FluidState",
    "Sources",
    "reference_init",
    "zero_state",
    "zero_sources",
    "StableFluids2D",
    "make_step_fn",
    "simulate",
    "step",
    "step_audited",
    "__version__",
]
