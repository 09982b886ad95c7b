"""Multi-chip sharding on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gfx_ocean_tpu import OceanConfig, OceanState, make_step
from gfx_ocean_tpu.golden.reference import golden_fields
from gfx_ocean_tpu.parallel import (
    ifft2_real_unnorm_sharded,
    make_mesh,
    make_sharded_rollout,
    make_sharded_step,
    shard_state,
)
from gfx_ocean_tpu.utils.complexpair import from_pair_np, to_pair


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(batch=2, row=4)


def _rand_state(rng, n, batch=None):
    shape = (batch, n, n) if batch else (n, n)
    h0 = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 0.1
    omega = np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1
    return OceanState(h0=jnp.asarray(to_pair(h0)), omega=jnp.asarray(omega))


def test_mesh_shape_validation():
    with pytest.raises(ValueError):
        make_mesh(batch=3)  # 3 does not divide 8


def test_sharded_step_matches_single_device(rng, mesh8):
    cfg = OceanConfig(resolution=64, compute_normals=True)
    state = _rand_state(rng, 64, batch=2)
    want = make_step(cfg)(state, jnp.float32(2.5))

    sstate = shard_state(state, mesh8)
    got = make_sharded_step(cfg, mesh8)(sstate, jnp.float32(2.5))
    np.testing.assert_allclose(np.asarray(got.displacement),
                               np.asarray(want.displacement), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(got.normals),
                               np.asarray(want.normals), atol=1e-4, rtol=0)


def test_sharded_step_unbatched(rng, mesh8):
    cfg = OceanConfig(resolution=64, compute_normals=False)
    state = _rand_state(rng, 64)
    want = make_step(cfg)(state, jnp.float32(1.0))
    got = make_sharded_step(cfg, mesh8, batched=False)(shard_state(state, mesh8),
                                                       jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(got.displacement),
                               np.asarray(want.displacement), atol=1e-4, rtol=0)


def test_sharded_step_vs_golden(rng, mesh8):
    cfg = OceanConfig(resolution=64, compute_normals=False)
    state = _rand_state(rng, 64, batch=2)
    got = make_sharded_step(cfg, mesh8)(shard_state(state, mesh8), jnp.float32(3.0))
    h0 = from_pair_np(np.asarray(state.h0))
    for b in range(2):
        want = golden_fields(h0[b], np.asarray(state.omega[b]), 3.0,
                             cfg.domain_size, cfg.compat)
        err = np.abs(np.asarray(got.displacement[b]) - want).max() / np.abs(want).max()
        assert err < 1e-4


def test_distributed_fft_matches_numpy(rng, mesh8):
    n = 128
    x = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    xr = jnp.asarray(np.real(x), dtype=jnp.float32)
    xi = jnp.asarray(np.imag(x), dtype=jnp.float32)

    got = np.asarray(jax.jit(
        lambda a, b: ifft2_real_unnorm_sharded(a, b, mesh8, precision="highest")
    )(xr, xi))
    want = np.real(np.fft.ifft2(x) * n * n)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_distributed_fft_batched(rng, mesh8):
    n = 64
    x = (rng.standard_normal((3, n, n)) + 1j * rng.standard_normal((3, n, n)))
    xr = jnp.asarray(np.real(x), dtype=jnp.float32)
    xi = jnp.asarray(np.imag(x), dtype=jnp.float32)
    got = np.asarray(jax.jit(
        lambda a, b: ifft2_real_unnorm_sharded(a, b, mesh8, precision="highest")
    )(xr, xi))
    want = np.real(np.fft.ifft2(x) * n * n)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_distributed_fft_four_step(rng, mesh8):
    """direct_max below N forces the four-step split inside the shard body
    (O(N) tables instead of a replicated dense W)."""
    n = 128
    x = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    xr = jnp.asarray(np.real(x), dtype=jnp.float32)
    xi = jnp.asarray(np.imag(x), dtype=jnp.float32)
    got = np.asarray(jax.jit(
        lambda a, b: ifft2_real_unnorm_sharded(a, b, mesh8, precision="highest",
                                               direct_max=32)
    )(xr, xi))
    want = np.real(np.fft.ifft2(x) * n * n)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("centered", ["ref", "canonical"])
def test_distributed_fft_centered_matches_single_chip(rng, mesh8, centered):
    """The folded centering sign agrees with the single-chip transform."""
    from gfx_ocean_tpu.ops.fft import ifft2_real_unnorm

    n = 64
    x = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    xr = jnp.asarray(np.real(x), dtype=jnp.float32)
    xi = jnp.asarray(np.imag(x), dtype=jnp.float32)
    got = np.asarray(jax.jit(
        lambda a, b: ifft2_real_unnorm_sharded(a, b, mesh8, precision="highest",
                                               centered=centered)
    )(xr, xi))
    want = np.asarray(ifft2_real_unnorm(xr, xi, precision="highest",
                                        centered=centered))
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(), rtol=0)


def test_distributed_fft_explicit_split_precision(rng, mesh8):
    """The bf16x3/bf16x4 tiers resolve inside the shard body (they used to
    crash jnp.matmul with a raw string)."""
    n = 64
    x = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    xr = jnp.asarray(np.real(x), dtype=jnp.float32)
    xi = jnp.asarray(np.imag(x), dtype=jnp.float32)
    want = np.real(np.fft.ifft2(x) * n * n)
    for precision in ("bf16x3", "bf16x4"):
        got = np.asarray(jax.jit(
            lambda a, b, p=precision: ifft2_real_unnorm_sharded(
                a, b, mesh8, precision=p))(xr, xi))
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_sharded_step_shard_map_fft(rng, mesh8):
    """step() with the explicit-collective FFT == single-device step."""
    cfg = OceanConfig(resolution=64, compute_normals=True)
    state = _rand_state(rng, 64, batch=2)
    want = make_step(cfg)(state, jnp.float32(2.5))
    got = make_sharded_step(cfg, mesh8, fft="shard_map")(
        shard_state(state, mesh8), jnp.float32(2.5))
    np.testing.assert_allclose(np.asarray(got.displacement),
                               np.asarray(want.displacement), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(got.normals),
                               np.asarray(want.normals), atol=1e-4, rtol=0)


def test_sharded_rollout_shard_map_fft(rng, mesh8):
    cfg = OceanConfig(resolution=64, compute_normals=False)
    state = _rand_state(rng, 64, batch=2)
    ts = jnp.arange(4, dtype=jnp.float32) * 0.25
    a = np.asarray(make_sharded_rollout(cfg, mesh8, fft="shard_map")(
        shard_state(state, mesh8), ts))
    b = np.asarray(make_sharded_rollout(cfg, mesh8)(shard_state(state, mesh8), ts))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-3)


def test_sharded_rollout_matches_single_device(rng, mesh8):
    from gfx_ocean_tpu import make_rollout

    cfg = OceanConfig(resolution=64, compute_normals=False)
    state = _rand_state(rng, 64, batch=2)
    ts = jnp.arange(4, dtype=jnp.float32) * 0.25
    want = np.asarray(make_rollout(cfg, keep_fields=False)(state, ts))
    got = np.asarray(make_sharded_rollout(cfg, mesh8)(shard_state(state, mesh8), ts))
    # checksums are near-cancelling sums over 64^2*3 values: allow
    # reduction-order noise across shardings
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)


def test_sharded_rollout_time_batched(rng, mesh8):
    cfg = OceanConfig(resolution=64, compute_normals=False)
    state = _rand_state(rng, 64, batch=2)
    ts = jnp.arange(4, dtype=jnp.float32) * 0.25
    a = np.asarray(make_sharded_rollout(cfg, mesh8, time_batch=2)(
        shard_state(state, mesh8), ts))
    b = np.asarray(make_sharded_rollout(cfg, mesh8)(shard_state(state, mesh8), ts))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-3)


def test_distributed_fft_planes_matches_single_chip(rng, mesh8):
    """The complex-output (packed-field) sharded transform == the
    single-chip ifft2_planes_unnorm, centering fold included."""
    from gfx_ocean_tpu.ops.fft import ifft2_planes_unnorm
    from gfx_ocean_tpu.parallel.distributed_fft import (
        ifft2_planes_unnorm_sharded)

    n = 64
    x = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    xr = jnp.asarray(np.real(x), dtype=jnp.float32)
    xi = jnp.asarray(np.imag(x), dtype=jnp.float32)
    gr, gi = jax.jit(
        lambda a, b: ifft2_planes_unnorm_sharded(a, b, mesh8,
                                                 precision="highest",
                                                 centered="ref"))(xr, xi)
    wr, wi = ifft2_planes_unnorm(xr, xi, precision="highest", centered="ref")
    scale = np.abs(np.asarray(wr)).max()
    np.testing.assert_allclose(np.asarray(gr), np.asarray(wr),
                               atol=1e-3 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(gi), np.asarray(wi),
                               atol=1e-3 * scale, rtol=0)


def test_sharded_step_packed_both_strategies(rng, mesh8):
    """The 4096^2-class configuration (hermitian_pack) runs under BOTH
    sharding strategies, and gspmd == shard_map == single-chip."""
    cfg = OceanConfig(resolution=64, compute_normals=True,
                      hermitian_pack=True)
    state = _rand_state(rng, 64, batch=2)
    t = jnp.float32(2.5)
    want = make_step(cfg)(state, t)
    for fft in ("gspmd", "shard_map"):
        got = make_sharded_step(cfg, mesh8, fft=fft)(
            shard_state(state, mesh8), t)
        np.testing.assert_allclose(np.asarray(got.displacement),
                                   np.asarray(want.displacement),
                                   atol=1e-4, rtol=0)


def test_sharded_rollout_packed_shard_map(rng, mesh8):
    """Packed rollout (scan + time_batch) on the explicit-collective
    transform agrees with GSPMD."""
    cfg = OceanConfig(resolution=64, compute_normals=False,
                      hermitian_pack=True)
    state = _rand_state(rng, 64, batch=2)
    ts = jnp.arange(4, dtype=jnp.float32) * 0.25
    a = np.asarray(make_sharded_rollout(cfg, mesh8, fft="shard_map",
                                        time_batch=2)(
        shard_state(state, mesh8), ts))
    b = np.asarray(make_sharded_rollout(cfg, mesh8, time_batch=2)(
        shard_state(state, mesh8), ts))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-3)


@pytest.mark.slow
def test_sharded_frame_renderer_bit_equal(mesh8):
    """Band-parallel rendering over the mesh (each device rasterizes a
    horizontal band of the viewport) is BIT-equal to the single-chip
    fused renderer — on the full 8-device render split and on a
    (batch=2, row=4) mesh where the split rides one axis."""
    from gfx_ocean_tpu.models.ocean import (downsample_state,
                                            ocean_state_from_assets)
    from gfx_ocean_tpu.parallel.render import make_sharded_frame_renderer
    from gfx_ocean_tpu.render.camera import Camera, perspective
    from gfx_ocean_tpu.render.raster import make_frame_renderer

    cfg = OceanConfig(resolution=64, mesh_resolution=32)
    state = downsample_state(ocean_state_from_assets(), 64)
    W, H = 96, 64
    cam = Camera()
    vp = jnp.asarray((perspective(W / H) @ cam.view()).astype(np.float32))
    cp = jnp.asarray(cam.position.astype(np.float32))
    t = jnp.float32(7.0)
    want = np.asarray(make_frame_renderer(cfg, W, H, giants=64)(
        state, t, vp, cp))
    got = np.asarray(make_sharded_frame_renderer(cfg, mesh8, W, H,
                                                 giants=64, axis="row")(
        state, t, vp, cp))
    np.testing.assert_array_equal(got, want)
    full = make_mesh(batch=1)   # all 8 devices on the render axis
    got8 = np.asarray(make_sharded_frame_renderer(cfg, full, W, H,
                                                  giants=64)(
        state, t, vp, cp))
    np.testing.assert_array_equal(got8, want)


def test_sharded_frame_renderer_validates_height(mesh8):
    from gfx_ocean_tpu.parallel.render import make_sharded_frame_renderer

    with pytest.raises(ValueError, match="height"):
        make_sharded_frame_renderer(OceanConfig(resolution=64), mesh8,
                                    96, 50, axis="row")   # 50 % 4 != 0


@pytest.mark.slow
def test_sharded_batch_renderer_bit_equal(mesh8):
    """Offline production split: frames DP over 'batch' x bands over
    'row' — bit-equal to the single-chip batched renderer."""
    from gfx_ocean_tpu.models.ocean import (downsample_state,
                                            ocean_state_from_assets)
    from gfx_ocean_tpu.parallel.render import make_sharded_batch_renderer
    from gfx_ocean_tpu.render.camera import Camera, perspective, scripted_camera
    from gfx_ocean_tpu.render.raster import make_batch_renderer

    cfg = OceanConfig(resolution=64, mesh_resolution=32)
    state = downsample_state(ocean_state_from_assets(), 64)
    W, H = 96, 64
    proj = perspective(W / H)
    cams = [c for _, c in scripted_camera([(4, ["w"])], dt=0.2)]
    vps = jnp.asarray(np.stack([(proj @ c.view()).astype(np.float32)
                                for c in cams]))
    cps = jnp.asarray(np.stack([c.position.astype(np.float32)
                                for c in cams]))
    ts = jnp.arange(4, dtype=jnp.float32) * 0.5
    want = np.asarray(make_batch_renderer(cfg, W, H, giants=64)(
        state, ts, vps, cps))
    fn = make_sharded_batch_renderer(cfg, mesh8, W, H, giants=64)
    got = np.asarray(fn(state, ts, vps, cps))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="frame count"):
        fn(state, ts[:3], vps[:3], cps[:3])   # 3 % batch=2 != 0


@pytest.mark.slow
def test_band_fuzz_adversarial_poses_diag_clean(mesh8):
    """Band fuzz at adversarial poses with the in-graph coverage
    tripwire: horizon crossing band edges, grazing camera, camera pitched past the horizon. For every
    pose the sharded frame must (a) report ZERO giant-pass drops via
    ``diag=True`` — the in-graph counter that catches a horizon-band
    overflow without a hardware sweep — and (b)
    stay bit-equal to the single-chip frame. ``giants`` is deliberately
    small (16) so a band whose overflow out-ran absorption WOULD trip
    the counter rather than hide behind a roomy default."""
    from gfx_ocean_tpu.models.ocean import (downsample_state,
                                            ocean_state_from_assets)
    from gfx_ocean_tpu.parallel.render import make_sharded_frame_renderer
    from gfx_ocean_tpu.render.camera import Camera, perspective
    from gfx_ocean_tpu.render.raster import make_frame_renderer

    cfg = OceanConfig(resolution=64, mesh_resolution=32)
    state = downsample_state(ocean_state_from_assets(), 64)
    W, H = 96, 64
    t = jnp.float32(7.0)
    one = make_frame_renderer(cfg, W, H, giants=16)
    band = make_sharded_frame_renderer(cfg, mesh8, W, H, giants=16,
                                       axis="row", diag=True)
    poses = [
        (-0.6, -1.5),    # default pose
        (-0.05, -1.5),   # horizon near the top band edge
        (-0.35, -1.5),   # horizon mid-frame (crosses an interior band)
        (0.25, -1.5),    # pitched above the horizon (sky-heavy, grazing)
        (-1.2, -0.3),    # steep down-look, rotated
    ]
    for rx, ry in poses:
        cam = Camera()
        cam.rotation = np.array([rx, ry, 0.0])
        vp = jnp.asarray((perspective(W / H) @ cam.view()).astype(np.float32))
        cp = jnp.asarray(cam.position.astype(np.float32))
        want = np.asarray(one(state, t, vp, cp))
        got, dropped = band(state, t, vp, cp)
        dropped = np.asarray(dropped)
        assert dropped.shape == (4,) and (dropped == 0).all(), (
            f"pose ({rx}, {ry}): giant-pass drops per band {dropped}")
        np.testing.assert_array_equal(np.asarray(got), want,
                                      err_msg=f"pose ({rx}, {ry})")
