"""Complex arrays as (re, im) float32 plane pairs at the jit boundary.

Complex64 never crosses the host<->device boundary in this framework: the
public step/state API carries (re, im) f32 planes, which every backend
transfers and which keep (N, N) tiles in a leading plane axis. Complex
math *inside* a jitted computation is fine — XLA decomposes it into real
ops.

Convention: a complex array of shape (..., N, N) is carried as float32
(..., 2, N, N) with plane 0 = real, plane 1 = imaginary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_pair(x: np.ndarray) -> np.ndarray:
    """Host-side: complex (..., N, N) -> float32 (..., 2, N, N)."""
    x = np.asarray(x)
    return np.stack([np.real(x), np.imag(x)], axis=-3).astype(np.float32)


def pair_to_complex(x: jnp.ndarray) -> jnp.ndarray:
    """Trace-side: float32 (..., 2, N, N) -> complex64 (..., N, N)."""
    return jax.lax.complex(x[..., 0, :, :], x[..., 1, :, :])


def from_pair_np(x: np.ndarray) -> np.ndarray:
    """Host-side inverse of ``to_pair`` (numpy, for tests/golden)."""
    x = np.asarray(x)
    return x[..., 0, :, :] + 1j * x[..., 1, :, :]
