"""Point queries of the displaced surface (gfx_ocean_tpu.query).

The reference has no readback at all — these tests pin the query API to
the renderer's own surface definition: same sampler
(shade._sample_bilinear_wrap), same world mapping (grid step 1,
uv = world / (h - 1)), same ocean.vert:22-23 scales.
"""

import numpy as np
import jax.numpy as jnp

import gfx_ocean_tpu as ot
from gfx_ocean_tpu.models.ocean import downsample_state
from gfx_ocean_tpu.query import sample_surface
from gfx_ocean_tpu.render import shade as sh


def _fields_128():
    state = downsample_state(ot.ocean_state_from_assets(), 128)
    cfg = ot.OceanConfig(resolution=128)
    return ot.make_step(cfg)(state, jnp.float32(7.5))


def test_zero_choppy_is_direct_bilinear():
    disp = np.asarray(_fields_128().displacement).copy()
    disp[..., 0] = 0.0
    disp[..., 2] = 0.0
    disp = jnp.asarray(disp)
    x = jnp.asarray([3.2, 40.0, 126.9, 200.5])
    z = jnp.asarray([10.0, 77.3, 0.1, 191.0])
    out = sample_surface(disp, x, z)
    want = sh.sample_displacement(disp, x / 127.0, z / 127.0)[..., 1] / 3.0
    np.testing.assert_allclose(np.asarray(out.height), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.base_xz),
                               np.stack([x, z], -1), atol=1e-6)
    assert np.all(np.asarray(out.residual) < 1e-5)


def test_constant_shift_inverts_exactly():
    """dx = a, dz = b everywhere: one iteration lands the fixed point."""
    n = 64
    rng = np.random.default_rng(0)
    disp = np.zeros((n, n, 3), np.float32)
    disp[..., 0] = 7.0
    disp[..., 2] = -3.5
    disp[..., 1] = rng.normal(size=(n, n)).astype(np.float32)
    dj = jnp.asarray(disp)
    x, z = jnp.asarray([50.0, 12.25]), jnp.asarray([20.0, 33.75])
    out = sample_surface(dj, x, z, mesh_resolution=128)
    bx, bz = x - 7.0 / 3.5, z + 3.5 / 3.5
    np.testing.assert_allclose(np.asarray(out.base_xz),
                               np.stack([bx, bz], -1), atol=1e-5)
    want = sh.sample_displacement(dj, bx / 127.0, bz / 127.0)[..., 1] / 3.0
    np.testing.assert_allclose(np.asarray(out.height), np.asarray(want),
                               atol=1e-6)
    assert np.all(np.asarray(out.residual) < 1e-5)


def test_parametric_surface_consistency(shipped_assets):
    """Query at a displaced point recovers that point's height wherever
    the choppy inversion converged (residual below tolerance). The bound
    on the converged share is a property of the shipped sea, which folds
    less than the synthesized one."""
    disp = _fields_128().displacement
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.uniform(0, 254, size=64).astype(np.float32))
    z0 = jnp.asarray(rng.uniform(0, 254, size=64).astype(np.float32))
    d = sh.sample_displacement(disp, x0 / 127.0, z0 / 127.0)
    wx = x0 + d[..., 0] / 3.5
    wz = z0 + d[..., 2] / 3.5
    wy = d[..., 1] / 3.0
    out = sample_surface(disp, wx, wz, iterations=12)
    res = np.asarray(out.residual)
    ok = res < 1e-3
    # the shipped sea at this scale is not folding everywhere; the fixed
    # point must converge for the bulk of random points
    assert ok.mean() > 0.9
    err = np.abs(np.asarray(out.height) - np.asarray(wy))
    assert err[ok].max() < 5e-3


def test_zero_tail_cascade_matches_single():
    disp = _fields_128().displacement
    stack = jnp.stack([disp, jnp.zeros_like(disp)])
    x = jnp.asarray([15.0, 90.0])
    z = jnp.asarray([55.5, 7.0])
    a = sample_surface(disp, x, z)
    b = sample_surface(stack, x, z, tiles=(1.0, 4.0))
    np.testing.assert_array_equal(np.asarray(a.height), np.asarray(b.height))
    np.testing.assert_array_equal(np.asarray(a.normal), np.asarray(b.normal))


def test_normal_matches_analytic_slope():
    """Linear height ramp (no choppy): normal = normalize(-slope, 1, 0)."""
    n = 128
    disp = np.zeros((n, n, 3), np.float32)
    disp[..., 1] = np.arange(n, dtype=np.float32)[None, :] * 0.5
    dj = jnp.asarray(disp)
    # mid-domain, away from the wrap seam at the texture edge
    out = sample_surface(dj, jnp.asarray([60.0]), jnp.asarray([60.0]),
                         mesh_resolution=128)
    # height(x) = 0.5 * (x * 128/127 - 0.5) / 3.0
    slope = 0.5 * (128.0 / 127.0) / 3.0
    want = np.array([-slope, 1.0, 0.0])
    want /= np.linalg.norm(want)
    np.testing.assert_allclose(np.asarray(out.normal)[0], want, atol=1e-4)


def test_batched_shapes():
    disp = _fields_128().displacement
    x = jnp.zeros((3, 5)) + 42.0
    z = jnp.linspace(0.0, 100.0, 15).reshape(3, 5)
    out = sample_surface(disp, x, z)
    assert out.height.shape == (3, 5)
    assert out.base_xz.shape == (3, 5, 2)
    assert out.normal.shape == (3, 5, 3)
    assert np.all(np.isfinite(np.asarray(out.normal)))
