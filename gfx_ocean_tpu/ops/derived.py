"""Post-FFT field assembly: correction, normals, foam.

JAX equivalents of ``shader/correction.comp`` (sign fix-up + packing into
the rgba32f displacement texture) and ``shader/ocean.frag:50-67`` (the
finite-difference normal map the reference recomputes per fragment — here a
vectorized pass over the whole grid, fused by XLA into the step), plus the
Jacobian whitecap mask (BASELINE.json config 4; no reference counterpart).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from gfx_ocean_tpu.config import OceanConfig


@functools.lru_cache(maxsize=None)
def _sign_np(n: int, ref_sign: bool) -> np.ndarray:
    x = np.arange(n)[None, :]
    y = np.arange(n)[:, None]
    even = (x + y) % 2 == 0
    if ref_sign:  # Q2: reference flips the canonical convention
        return np.where(even, np.float32(-1.0), np.float32(1.0))
    return np.where(even, np.float32(1.0), np.float32(-1.0))


def correction_sign(n: int, ref_sign: bool = True) -> jnp.ndarray:
    """(N, N) sign grid of ``shader/correction.comp:29``."""
    return jnp.asarray(_sign_np(n, ref_sign))


def correction(
    f_height: jnp.ndarray,
    f_dx: jnp.ndarray,
    f_dz: jnp.ndarray,
    ref_sign: bool = True,
) -> jnp.ndarray:
    """Take real parts, apply the centering sign, pack (dx, h, dz).

    Mirrors ``shader/correction.comp:31-34``: the displacement texture
    channel order is (disp_x, height, disp_z). Returns (..., N, N, 3) f32.
    """
    n = f_height.shape[-1]
    sign = correction_sign(n, ref_sign)
    fx = jnp.real(f_dx) * sign
    fy = jnp.real(f_height) * sign
    fz = jnp.real(f_dz) * sign
    return jnp.stack([fx, fy, fz], axis=-1)


def finite_difference_normals_planes(
        height: jnp.ndarray, height_scale: float = 180.0) -> jnp.ndarray:
    """Central-difference normal map in PLANE-MAJOR (..., 3, N, N) layout.

    Same math as :func:`finite_difference_normals` (the public
    channel-last form) but stacked on axis -3, the layout-correct form for
    plane-major consumers that materialize normals.
    """
    n0, n1 = height.shape[-2], height.shape[-1]
    diff_x = jnp.float32(2.0 / n1)
    diff_y = jnp.float32(2.0 / n0)
    x0 = jnp.roll(height, 1, axis=-1)
    x1 = jnp.roll(height, -1, axis=-1)
    z0 = jnp.roll(height, 1, axis=-2)
    z1 = jnp.roll(height, -1, axis=-2)

    gx = (x1 - x0) / height_scale
    gz = (z1 - z0) / height_scale

    # na = normalize([-dx, gx, 0]); nb = normalize([0, gz, dy]);
    # cross(na, nb) = (gx*dy - 0, 0 - (-dx*dy), -dx*gz - 0) / (|na||nb|)
    # The two normalizations scale the cross product uniformly per texel, so
    # fold them into the final normalize — same result, fewer rsqrts.
    cx = gx * diff_y
    cy = diff_x * diff_y
    cz = -diff_x * gz
    length = jnp.sqrt(cx * cx + cy * cy + cz * cz)
    return jnp.stack([cx / length, cy / length, cz / length], axis=-3)


def finite_difference_normals(height: jnp.ndarray, height_scale: float = 180.0) -> jnp.ndarray:
    """Central-difference normal map (``shader/ocean.frag:50-67``).

    The reference samples +-1 texel with repeat wrap (sampler Tile,
    ``src/render.rs:397-398``): texture x = array axis -1, texture y = axis
    -2. na = normalize(-diff_x, (x1-x0)/hs, 0); nb = normalize(0,
    (z1-z0)/hs, diff_y); N = normalize(cross(na, nb)).
    Returns (..., N, N, 3) float32.
    """
    return jnp.moveaxis(
        finite_difference_normals_planes(height, height_scale), -3, -1)


def jacobian_foam(
    displacement: jnp.ndarray,
    config: OceanConfig,
    domain_size: float | None = None,
) -> jnp.ndarray:
    """Whitecap mask from the Jacobian of the horizontal displacement map.

    J = (1 + l*dDx/dx)(1 + l*dDz/dz) - (l*dDx/dz)(l*dDz/dx); foam = J < thr.
    Central differences with wrap; grid spacing = L / N (pass
    ``domain_size`` to override for a cascade's own patch size).
    Returns f32 mask.
    """
    n = displacement.shape[-2]
    spacing = (domain_size if domain_size is not None else config.domain_size) / n
    lam = jnp.float32(config.foam_lambda)
    inv2h = jnp.float32(1.0 / (2.0 * spacing))

    fx = displacement[..., 0]
    fz = displacement[..., 2]

    def ddx(f):  # texture x = axis -1
        return (jnp.roll(f, -1, axis=-1) - jnp.roll(f, 1, axis=-1)) * inv2h

    def ddz(f):  # texture y = axis -2
        return (jnp.roll(f, -1, axis=-2) - jnp.roll(f, 1, axis=-2)) * inv2h

    jxx = 1.0 + lam * ddx(fx)
    jzz = 1.0 + lam * ddz(fz)
    jxz = lam * ddz(fx)
    jzx = lam * ddx(fz)
    jac = jxx * jzz - jxz * jzx
    return (jac < config.foam_threshold).astype(jnp.float32)
