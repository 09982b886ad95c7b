"""gfx_ocean_tpu — a JAX rebuild of the gfx-rs/gfx-ocean FFT ocean.

The reference is a Rust + gfx-hal + GLSL real-time Tessendorf ocean
demo; this package re-designs it as a JAX program (run on a GPU; tests
run on the CPU):

- the four compute passes (propagate / fft_row / fft_col / correction)
  become a pure ``step(state, t)`` under ``jax.jit`` (``models/ocean.py``),
  with the 2-D inverse FFT as dense matmuls or ``jnp.fft`` (``ops/fft.py``);
- frames-in-flight pipelining becomes ``jax.lax.scan`` rollouts;
- the renderer (``shader/ocean.vert``/``.frag``) becomes a vectorized JAX
  rasterizer along a scripted camera (``render/``);
- multi-device scaling (which the reference lacks entirely) ships in
  ``parallel/``: row-sharded spectra with an all-to-all transpose between
  the row and column FFT passes over a ``jax.sharding.Mesh``.
"""

from gfx_ocean_tpu.config import CompatFlags, OceanConfig, PhillipsConfig
from gfx_ocean_tpu.query import SurfaceSample, sample_surface
from gfx_ocean_tpu.models.ocean import (
    OceanFields,
    OceanState,
    make_rollout,
    make_step,
    ocean_state_from_assets,
    ocean_state_from_phillips,
    step,
)

__version__ = "0.1.0"

__all__ = [
    "CompatFlags",
    "OceanConfig",
    "OceanFields",
    "OceanState",
    "PhillipsConfig",
    "make_rollout",
    "make_step",
    "ocean_state_from_assets",
    "ocean_state_from_phillips",
    "sample_surface",
    "step",
    "SurfaceSample",
]
