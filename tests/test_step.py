"""End-to-end step() vs the CPU golden model (BASELINE configs 1 & 2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gfx_ocean_tpu import CompatFlags, OceanConfig, OceanState, make_rollout, make_step
from gfx_ocean_tpu.golden.reference import golden_fields, golden_normals
from gfx_ocean_tpu.models.ocean import downsample_state, ocean_state_from_assets
from gfx_ocean_tpu.utils.complexpair import from_pair_np, to_pair


def _state(reference_state, n):
    h0, omega = reference_state
    st = OceanState(h0=jnp.asarray(to_pair(h0)), omega=jnp.asarray(omega))
    return downsample_state(st, n)


def _linf_rel(got, want):
    scale = np.abs(want).max()
    return np.abs(np.asarray(got, dtype=np.float64) - want).max() / scale


@pytest.mark.parametrize("impl", ["matmul", "xla"])
@pytest.mark.parametrize("n", [256, 512])
def test_step_matches_golden(reference_state, impl, n):
    """Config 1 (256^2 height-only) and config 2 (512^2 full step)."""
    cfg = OceanConfig(resolution=n, fft_impl=impl, compute_normals=False)
    st = _state(reference_state, n)
    t = 11.25
    got = make_step(cfg)(st, jnp.float32(t))
    want = golden_fields(from_pair_np(np.asarray(st.h0)), np.asarray(st.omega), t,
                         cfg.domain_size, cfg.compat)
    err = _linf_rel(got.displacement, want)
    assert err < 1e-5, f"relative L-inf {err:.2e} at N={n} impl={impl}"


@pytest.mark.parametrize("flags", [
    CompatFlags(wrap_k=True, ref_sign=True, conj_neg=False),   # bit-parity mode
    CompatFlags(wrap_k=False, ref_sign=False, conj_neg=True),  # canonical mode
])
def test_step_compat_flags(reference_state, flags):
    cfg = OceanConfig(resolution=128, compat=flags, compute_normals=False)
    st = _state(reference_state, 128)
    t = 3.5
    got = make_step(cfg)(st, jnp.float32(t))
    want = golden_fields(from_pair_np(np.asarray(st.h0)), np.asarray(st.omega), t,
                         cfg.domain_size, flags)
    assert _linf_rel(got.displacement, want) < 1e-5


def test_normals_match_golden(reference_state):
    cfg = OceanConfig(resolution=128)
    st = _state(reference_state, 128)
    got = make_step(cfg)(st, jnp.float32(7.0))
    want = golden_normals(np.asarray(got.displacement[..., 1], dtype=np.float64),
                          cfg.normal_height_scale)
    assert np.abs(np.asarray(got.normals) - want).max() < 1e-4
    lens = np.linalg.norm(np.asarray(got.normals), axis=-1)
    assert np.abs(lens - 1.0).max() < 1e-5
    # Ocean normals point up on average.
    assert np.asarray(got.normals)[..., 1].mean() > 0.5


def test_normals_planes_layout_matches_channel_last(reference_state):
    """The plane-major normals (the checksum rollout's native layout —
    round 5) must be exactly the moveaxis of the public channel-last
    form, including with a leading batch axis."""
    from gfx_ocean_tpu.ops.derived import (
        finite_difference_normals, finite_difference_normals_planes)

    cfg = OceanConfig(resolution=128)
    st = _state(reference_state, 128)
    h = make_step(cfg)(st, jnp.float32(7.0)).displacement[..., 1]
    a = np.asarray(finite_difference_normals(h, cfg.normal_height_scale))
    b = np.asarray(finite_difference_normals_planes(
        h, cfg.normal_height_scale))
    np.testing.assert_array_equal(np.moveaxis(b, -3, -1), a)
    hb = jnp.stack([h, h * 1.25])
    bb = np.asarray(finite_difference_normals_planes(
        hb, cfg.normal_height_scale))
    assert bb.shape == (2, 3, 128, 128)
    np.testing.assert_array_equal(bb[0], b)


def test_rollout_scan_matches_individual_steps(reference_state):
    cfg = OceanConfig(resolution=64, compute_normals=False)
    st = _state(reference_state, 64)
    ts = jnp.arange(5, dtype=jnp.float32) * 0.3 + 1.0
    rollout = make_rollout(cfg)
    traj = rollout(st, ts)
    step_fn = make_step(cfg)
    for i, t in enumerate(np.asarray(ts)):
        single = step_fn(st, jnp.float32(t))
        np.testing.assert_allclose(
            np.asarray(traj.displacement[i]), np.asarray(single.displacement),
            rtol=0, atol=1e-5)


def test_rollout_checksum_mode(reference_state):
    cfg = OceanConfig(resolution=64, compute_normals=False)
    st = _state(reference_state, 64)
    ts = jnp.arange(3, dtype=jnp.float32)
    out = make_rollout(cfg, keep_fields=False)(st, ts)
    assert out.shape == (3,)
    assert np.all(np.isfinite(np.asarray(out)))


def test_rollout_deterministic(reference_state):
    cfg = OceanConfig(resolution=64, compute_normals=False)
    st = _state(reference_state, 64)
    ts = jnp.arange(4, dtype=jnp.float32) * 0.1
    r = make_rollout(cfg, keep_fields=False)
    a, b = r(st, ts), r(st, ts)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_stateless_resume(reference_state):
    """Checkpoint/resume = pass a later t (SURVEY.md §5): a frame computed
    directly at t equals the same frame computed 'after' other frames."""
    cfg = OceanConfig(resolution=64, compute_normals=False)
    st = _state(reference_state, 64)
    step_fn = make_step(cfg)
    _ = step_fn(st, jnp.float32(1.0))
    _ = step_fn(st, jnp.float32(2.0))
    direct = step_fn(st, jnp.float32(42.0))
    fresh = make_step(cfg)(st, jnp.float32(42.0))
    assert np.array_equal(np.asarray(direct.displacement), np.asarray(fresh.displacement))


def test_foam_shape_and_range(reference_state):
    cfg = OceanConfig(resolution=128, compute_foam=True, compute_normals=False)
    st = _state(reference_state, 128)
    out = make_step(cfg)(st, jnp.float32(5.0))
    foam = np.asarray(out.foam)
    assert foam.shape == (128, 128)
    assert set(np.unique(foam)).issubset({0.0, 1.0})


def test_loads_reference_assets_end_to_end():
    st = ocean_state_from_assets()
    assert st.h0.shape == (2, 512, 512)
    cfg = OceanConfig(resolution=512, compute_normals=False)
    out = make_step(cfg)(st, jnp.float32(0.5))
    assert np.all(np.isfinite(np.asarray(out.displacement)))


def test_uniform_rollout_phase_recurrence_accuracy(reference_state):
    """Phase recurrence must match exact phases to ~1e-5 over many frames."""
    from gfx_ocean_tpu.models.ocean import make_uniform_rollout

    cfg = OceanConfig(resolution=64, compute_normals=False)
    st = _state(reference_state, 64)
    steps, dt = 100, 1 / 60
    rec = make_uniform_rollout(cfg, steps, dt, keep_fields=True,
                               phase_recurrence=True, resync_every=32)(st, 0.5)
    exact = make_uniform_rollout(cfg, steps, dt, keep_fields=True,
                                 phase_recurrence=False)(st, 0.5)
    a = np.asarray(rec.displacement)
    b = np.asarray(exact.displacement)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-5


def test_uniform_rollout_matches_make_rollout(reference_state):
    from gfx_ocean_tpu.models.ocean import make_uniform_rollout

    cfg = OceanConfig(resolution=64, compute_normals=False)
    st = _state(reference_state, 64)
    steps, dt = 8, 0.25
    a = np.asarray(make_uniform_rollout(cfg, steps, dt,
                                        phase_recurrence=False)(st, 1.0))
    ts = 1.0 + jnp.arange(steps, dtype=jnp.float32) * jnp.float32(dt)
    b = np.asarray(make_rollout(cfg, keep_fields=False)(st, ts))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)


def test_uniform_rollout_rejects_pallas(reference_state):
    """The fused Pallas step is gone: fft_impl takes matmul or xla."""
    with pytest.raises(ValueError, match="unknown fft_impl 'pallas'"):
        OceanConfig(fft_impl="pallas")


def test_choppy_precision_split(reference_state):
    """LOD split: height channel must be unaffected by choppy precision."""
    st = _state(reference_state, 64)
    full = OceanConfig(resolution=64, compute_normals=False,
                       matmul_precision="highest")
    lod = dataclasses.replace(full, choppy_precision="default")
    a = np.asarray(make_step(full)(st, jnp.float32(2.0)).displacement)
    b = np.asarray(make_step(lod)(st, jnp.float32(2.0)).displacement)
    np.testing.assert_allclose(a[..., 1], b[..., 1], atol=1e-6)  # height identical
    assert b.shape == a.shape


def test_long_rollout_stability(reference_state):
    """Property (SURVEY.md §4): the stateless sim cannot blow up — field
    magnitudes stay in a fixed band over a long rollout."""
    cfg = OceanConfig(resolution=64, compute_normals=False)
    st = _state(reference_state, 64)
    ts = jnp.arange(200, dtype=jnp.float32) * 0.37
    traj = make_rollout(cfg, keep_fields=True)(st, ts)
    heights = np.abs(np.asarray(traj.displacement[..., 1])).max(axis=(1, 2))
    assert np.all(np.isfinite(heights))
    assert heights.max() < 4 * np.median(heights)
    assert heights.min() > np.median(heights) / 4


# --- Hermitian field packing (3 fields from 2 transforms) -------------------

@pytest.mark.parametrize("flags", [
    CompatFlags(),                                             # defaults
    CompatFlags(wrap_k=True, ref_sign=True, conj_neg=False),   # bit-parity
    CompatFlags(wrap_k=False, ref_sign=False, conj_neg=True),  # canonical
])
def test_packed_step_matches_golden(reference_state, flags):
    """hermitian_pack computes Re(F(S)) exactly (symmetrization identity)."""
    cfg = OceanConfig(resolution=128, compat=flags, compute_normals=False,
                      hermitian_pack=True, matmul_precision="highest")
    st = _state(reference_state, 128)
    t = 3.5
    got = make_step(cfg)(st, jnp.float32(t))
    want = golden_fields(from_pair_np(np.asarray(st.h0)), np.asarray(st.omega), t,
                         cfg.domain_size, flags)
    assert _linf_rel(got.displacement, want) < 1e-5


@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_packed_equals_unpacked(reference_state, impl):
    cfg = OceanConfig(resolution=256, fft_impl=impl, compute_normals=True,
                      matmul_precision="highest")
    cfgp = dataclasses.replace(cfg, hermitian_pack=True)
    st = _state(reference_state, 256)
    a = make_step(cfg)(st, jnp.float32(11.25))
    b = make_step(cfgp)(st, jnp.float32(11.25))
    scale = np.abs(np.asarray(a.displacement)).max()
    np.testing.assert_allclose(np.asarray(b.displacement),
                               np.asarray(a.displacement),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(b.normals), np.asarray(a.normals),
                               atol=1e-4, rtol=0)


def test_packed_four_step_regime(reference_state):
    """Packing composes with the four-step split (direct_max below N)."""
    cfg = OceanConfig(resolution=256, compute_normals=False,
                      hermitian_pack=True, direct_dft_max=64,
                      matmul_precision="highest")
    st = _state(reference_state, 256)
    got = make_step(cfg)(st, jnp.float32(5.0))
    want = golden_fields(from_pair_np(np.asarray(st.h0)), np.asarray(st.omega),
                         5.0, cfg.domain_size, cfg.compat)
    assert _linf_rel(got.displacement, want) < 1e-5


def test_packed_choppy_precision_split(reference_state):
    """choppy_precision still applies per-field under packing (height at
    matmul_precision, the packed dx/dz pair at choppy_precision)."""
    cfg = OceanConfig(resolution=128, compute_normals=False,
                      hermitian_pack=True, matmul_precision="highest",
                      choppy_precision="default")
    st = _state(reference_state, 128)
    got = make_step(cfg)(st, jnp.float32(2.0))
    want = golden_fields(from_pair_np(np.asarray(st.h0)), np.asarray(st.omega),
                         2.0, cfg.domain_size, cfg.compat)
    # height at full precision; choppy fields allowed bf16-grade error
    h_err = _linf_rel(got.displacement[..., 1], want[..., 1])
    assert h_err < 1e-5
    assert _linf_rel(got.displacement, want) < 0.05


def test_packed_rollout_matches_step(reference_state):
    cfg = OceanConfig(resolution=128, compute_normals=False,
                      hermitian_pack=True)
    st = _state(reference_state, 128)
    ts = jnp.asarray([0.5, 1.0], dtype=jnp.float32)
    traj = make_rollout(cfg, keep_fields=True)(st, ts)
    single = make_step(cfg)(st, ts[1])
    np.testing.assert_allclose(np.asarray(traj.displacement[1]),
                               np.asarray(single.displacement),
                               atol=1e-5, rtol=0)


def test_packed_cascades(reference_state):
    """Packing is elementwise over leading batch axes (cascade vmap-free)."""
    cfg = OceanConfig(resolution=64, compute_normals=False, hermitian_pack=True,
                      matmul_precision="highest")
    st = _state(reference_state, 64)
    batched = OceanState(h0=jnp.stack([st.h0, st.h0 * 0.5]),
                         omega=jnp.stack([st.omega, st.omega]))
    got = make_step(cfg)(batched, jnp.float32(1.5))
    single = make_step(cfg)(st, jnp.float32(1.5))
    np.testing.assert_allclose(np.asarray(got.displacement[0]),
                               np.asarray(single.displacement),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(got.displacement[1]),
                               np.asarray(single.displacement) * 0.5,
                               atol=1e-6, rtol=0)


def test_uniform_rollout_exact_at_large_t0():
    """Regression: the uniform rollout's exact_cs used a plain f32
    omega*t product (no Dekker reduction) — ~3e-4 rad off at t ~ 1000 s,
    diverging from make_rollout past the field budget."""
    import gfx_ocean_tpu as ot
    from gfx_ocean_tpu.models.ocean import downsample_state, make_uniform_rollout

    state = downsample_state(ot.ocean_state_from_assets(), 64)
    cfg = ot.OceanConfig(resolution=64, compute_normals=False)
    steps, dt, t0 = 2, 1.0 / 60.0, 1000.0
    a = np.asarray(make_uniform_rollout(cfg, steps, dt,
                                        keep_fields=True)(state, t0).displacement)
    ts = jnp.float32(t0) + jnp.arange(steps, dtype=jnp.float32) * jnp.float32(dt)
    b = np.asarray(ot.make_rollout(cfg, keep_fields=True)(state, ts).displacement)
    rel = np.abs(a - b).max() / np.abs(b).max()
    # measured 2.8e-6 with the Dekker phase; the plain f32 product put
    # this at ~3e-4 (the phase error itself)
    assert rel < 5e-5, rel


def test_sharded_rollout_rejects_bad_time_batch():
    """Same clear error contract as models.make_rollout."""
    import jax

    import gfx_ocean_tpu as ot
    from gfx_ocean_tpu.models.ocean import downsample_state
    from gfx_ocean_tpu.parallel import make_mesh, make_sharded_rollout, shard_state

    mesh = make_mesh(jax.devices()[:8], batch=2, row=4)
    base = downsample_state(ot.ocean_state_from_assets(), 64)
    state = shard_state(
        ot.OceanState(h0=jnp.stack([base.h0, base.h0]),
                      omega=jnp.stack([base.omega, base.omega])), mesh)
    cfg = ot.OceanConfig(resolution=64, compute_normals=False)
    ro = make_sharded_rollout(cfg, mesh, batched=True, time_batch=6)
    with pytest.raises(ValueError, match="not a multiple of"):
        ro(state, jnp.arange(100, dtype=jnp.float32))


@pytest.mark.parametrize("impl", ["matmul", "xla"])
@pytest.mark.parametrize("flags", [
    CompatFlags(),
    CompatFlags(wrap_k=True),
    CompatFlags(ref_sign=False),
    CompatFlags(conj_neg=True),
])
def test_step_each_compat_flag_matches_golden(reference_state, impl, flags):
    """Each quirk flag alone reaches both transforms (the matmul DFT with
    the sign folded into its tables; the xla FFT with the sign applied
    after it) and matches the float64 golden."""
    cfg = OceanConfig(resolution=128, fft_impl=impl, matmul_precision="highest",
                      compat=flags)
    st = _state(reference_state, 128)
    got = make_step(cfg)(st, jnp.float32(3.25))
    want = golden_fields(from_pair_np(np.asarray(st.h0)), np.asarray(st.omega),
                         3.25, cfg.domain_size, flags)
    err = _linf_rel(got.displacement, want)
    assert err < 1e-5, f"{impl} {flags}: {err:.2e}"


@pytest.mark.parametrize("impl", ["matmul", "xla"])
def test_large_t_phase_matches_golden(reference_state, impl):
    """At t ~ 1000 s a plain f32 omega*t product is ~3e-4 rad off; the
    Dekker-reduced phase keeps both transforms on the float64 golden."""
    cfg = OceanConfig(resolution=64, fft_impl=impl, matmul_precision="highest",
                      compute_normals=False)
    st = _state(reference_state, 64)
    t = 1000.25
    got = make_step(cfg)(st, jnp.float32(t))
    want = golden_fields(from_pair_np(np.asarray(st.h0)), np.asarray(st.omega),
                         t, cfg.domain_size, cfg.compat)
    err = _linf_rel(got.displacement, want)
    assert err < 1e-5, f"{impl} at t={t}: {err:.2e}"


@pytest.mark.parametrize("pack", [False, True])
def test_matmul_and_xla_agree(reference_state, pack):
    """The two transforms agree with Hermitian packing off and on (the
    packed choppy pair rides one complex transform in both)."""
    st = _state(reference_state, 128)
    t = jnp.float32(7.5)
    out = {impl: np.asarray(make_step(OceanConfig(
        resolution=128, fft_impl=impl, hermitian_pack=pack,
        matmul_precision="highest"))(st, t).displacement)
        for impl in ("matmul", "xla")}
    rel = (np.abs(out["matmul"] - out["xla"]).max()
           / np.abs(out["xla"]).max())
    assert rel < 1e-5, f"pack={pack}: {rel:.2e}"
