"""Phillips synthesis (BASELINE config 3) and cascades (config 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gfx_ocean_tpu as ot
from gfx_ocean_tpu.config import PhillipsConfig
from gfx_ocean_tpu.models.ocean import ocean_state_from_phillips
from gfx_ocean_tpu.spectra.phillips import dispersion, phillips_spectrum, synthesize


def test_dispersion_matches_shipped_omega(reference_state):
    """Regenerated omega must reproduce the loaded omega.bin (SURVEY.md
    §3.4): the shipped bin, or conftest's generated one without it.

    Criterion is the median: the shipped bin contains a few DC-adjacent
    outlier texels (min 0.1350 where sqrt(g|k|) on the centered odd grid
    gives 0.2088 — its unknown offline generator treated near-DC texels
    differently). 99.9% of texels agree to f32 rounding.
    """
    _, omega_ref = reference_state
    om = np.asarray(dispersion(512, 1000.0))
    err = np.abs(om.astype(np.float64) - omega_ref.astype(np.float64))
    assert np.median(err) < 1e-4
    assert np.quantile(err, 0.999) < 1e-3
    assert 4.7 < om.max() < 4.8


def test_phillips_spectrum_properties():
    p = phillips_spectrum(128, 1000.0, PhillipsConfig())
    assert p.shape == (128, 128)
    assert np.all(p >= 0)
    assert np.all(np.isfinite(p))
    # energy concentrates at low |k|: corner (high |k|) << peak
    assert p.max() > 100 * p[0, 0]


def test_phillips_directionality():
    cfg = PhillipsConfig(wind_direction=(1.0, 0.0))
    p = phillips_spectrum(64, 1000.0, cfg)
    n = 64
    # Compare symmetric texels: k mostly along wind (x) vs mostly across.
    # At (c, c+10) k = (19, -1) units -> |k_hat.w|^2 ~ 1; at (c+10, c)
    # k = (-1, 19) -> ~ 0.003. Same |k| by symmetry.
    c = (n + 1) // 2
    along = p[c, c + 10]
    across = p[c + 10, c]
    assert along > 100 * across


def test_jonswap_spectrum_properties():
    """Shape properties of the JONSWAP wave-vector spectrum: finite,
    nonnegative, zero at DC, peaked near k_p = w_p^2 / g (deep-water
    dispersion of the Hasselmann et al. peak frequency), and
    peak-normalized to the Phillips scale at the same parameters."""
    from gfx_ocean_tpu.spectra.phillips import jonswap_spectrum

    n, L = 256, 4000.0
    cfg = PhillipsConfig(model="jonswap")
    p = jonswap_spectrum(n, L, cfg)
    assert p.shape == (n, n)
    assert np.all(np.isfinite(p)) and np.all(p >= 0)
    # fetch-limited low-k rolloff: the near-DC texel (the centered even
    # grid has no exact k=0) sits ~10 orders below the peak
    mid = (n - 1) // 2
    assert p[mid, mid] < 1e-9 * p.max()
    # peak wavenumber: w_p = 22 (g^2/(U F))^(1/3); k_p = w_p^2 / g.
    g, u, fetch = cfg.gravity, cfg.wind_speed, cfg.fetch
    wp = 22.0 * (g * g / (u * fetch)) ** (1.0 / 3.0)
    kp = wp * wp / g
    iy, ix = np.unravel_index(np.argmax(p), p.shape)
    kx = np.pi * (2 * ix - n - 1) / L
    ky = np.pi * (2 * iy - n - 1) / L
    k_at_peak = np.hypot(kx, ky)
    dk = 2 * np.pi / L
    # peak along-wind within a few grid cells of k_p (directional factor
    # shifts it slightly above the omnidirectional peak)
    assert abs(k_at_peak - kp) < 4 * dk
    # peak-normalized to Phillips at the same (amplitude, wind)
    assert np.isclose(p.max(), phillips_spectrum(n, L, cfg).max())


def test_jonswap_gamma_sharpens_peak():
    """gamma > 1 concentrates energy at the peak: the fraction of total
    spectral mass inside a band around k_p is strictly higher at
    gamma = 3.3 than at gamma = 1 (Pierson-Moskowitz shape)."""
    from gfx_ocean_tpu.spectra.phillips import jonswap_spectrum

    n, L = 256, 4000.0
    pm = jonswap_spectrum(n, L, PhillipsConfig(model="jonswap",
                                               peak_enhancement=1.0))
    js = jonswap_spectrum(n, L, PhillipsConfig(model="jonswap",
                                               peak_enhancement=3.3))
    cfg = PhillipsConfig(model="jonswap")
    g, u, fetch = cfg.gravity, cfg.wind_speed, cfg.fetch
    wp = 22.0 * (g * g / (u * fetch)) ** (1.0 / 3.0)
    kp = wp * wp / g
    i = np.arange(n)
    kx = np.pi * (2 * i[None, :] - n - 1) / L
    ky = np.pi * (2 * i[:, None] - n - 1) / L
    band = np.abs(np.hypot(kx, ky) - kp) < 0.5 * kp
    conc_pm = pm[band].sum() / pm.sum()
    conc_js = js[band].sum() / js.sum()
    assert conc_js > conc_pm * 1.05
    # peak-normalization gives both the same maximum
    assert np.isclose(js.max(), pm.max())


def test_jonswap_state_runs_end_to_end():
    cfg = ot.OceanConfig(resolution=128, compute_normals=False)
    state = ocean_state_from_phillips(
        cfg, PhillipsConfig(model="jonswap", seed=3))
    out = ot.make_step(cfg)(state, jnp.float32(4.0))
    d = np.asarray(out.displacement)
    assert d.shape == (128, 128, 3)
    assert np.all(np.isfinite(d))
    assert np.abs(d[..., 1]).max() > 1e-3
    # magnitude commensurate with the Phillips state (peak normalization):
    # same render scalings must apply
    ph = ocean_state_from_phillips(cfg, PhillipsConfig(seed=3))
    dp = np.asarray(ot.make_step(cfg)(ph, jnp.float32(4.0)).displacement)
    r = np.abs(d[..., 1]).max() / np.abs(dp[..., 1]).max()
    assert 0.05 < r < 20.0


def test_jonswap_config_validation():
    with pytest.raises(ValueError):
        PhillipsConfig(model="tma")
    with pytest.raises(ValueError):
        PhillipsConfig(model="jonswap", fetch=0.0)
    with pytest.raises(ValueError):
        PhillipsConfig(model="jonswap", peak_enhancement=-1.0)
    with pytest.raises(ValueError):
        PhillipsConfig(depth=0.0)
    with pytest.raises(ValueError):
        PhillipsConfig(opposing_suppression=1.5)


def test_finite_depth_dispersion():
    """w = sqrt(g k tanh(k h)): finite depth only SLOWS waves, long waves
    approach the shallow limit k sqrt(g h), short waves the deep-water
    law, and depth=inf is exactly the deep-water grid."""
    n, L, g, h = 128, 10000.0, 9.81, 5.0
    deep = np.asarray(dispersion(n, L, g))
    fin = np.asarray(dispersion(n, L, g, depth=h))
    assert np.array_equal(deep, np.asarray(dispersion(n, L, g,
                                                      depth=np.inf)))
    assert np.all(fin <= deep + 1e-6)
    i = np.arange(n)
    kx = np.pi * (2 * i[None, :] - n - 1) / L
    ky = np.pi * (2 * i[:, None] - n - 1) / L
    k = np.hypot(kx, ky)
    shallow = k * np.sqrt(g * h)  # kh << 1 limit
    long_w = k * h < 0.1
    np.testing.assert_allclose(fin[long_w], shallow[long_w], rtol=2e-3)
    short_w = k * h > 5.0
    np.testing.assert_allclose(fin[short_w], deep[short_w], rtol=1e-3)


def test_opposing_suppression():
    """Energy on the upwind half-plane (k . w < 0) scales by the
    suppression factor; the downwind half is untouched."""
    n, L = 128, 1000.0
    base = phillips_spectrum(n, L, PhillipsConfig())
    sup = phillips_spectrum(
        n, L, PhillipsConfig(opposing_suppression=0.25))
    i = np.arange(n)
    kx = np.pi * (2 * i[None, :] - n - 1) / L
    upwind = np.broadcast_to(kx < 0, (n, n))  # wind is +x by default
    np.testing.assert_allclose(sup[upwind], 0.25 * base[upwind], rtol=1e-12)
    np.testing.assert_allclose(sup[~upwind], base[~upwind], rtol=0)
    # end-to-end: a fully one-sided sea still runs
    cfg = ot.OceanConfig(resolution=64, compute_normals=False)
    st = ocean_state_from_phillips(
        cfg, PhillipsConfig(opposing_suppression=0.0, depth=40.0, seed=2))
    d = np.asarray(ot.make_step(cfg)(st, jnp.float32(1.0)).displacement)
    assert np.all(np.isfinite(d)) and np.abs(d[..., 1]).max() > 1e-4


def test_synthesize_reproducible_and_hermitian_stats():
    key = jax.random.PRNGKey(7)
    h0a, oma = synthesize(64, 1000.0, PhillipsConfig(), key)
    h0b, omb = synthesize(64, 1000.0, PhillipsConfig(), key)
    assert np.array_equal(np.asarray(h0a), np.asarray(h0b))
    assert h0a.shape == (2, 64, 64)
    assert np.array_equal(np.asarray(oma), np.asarray(omb))
    # complex gaussian: re/im planes have comparable energy
    e_r = float(jnp.sum(h0a[0] ** 2))
    e_i = float(jnp.sum(h0a[1] ** 2))
    assert 0.5 < e_r / e_i < 2.0


def test_synthesized_state_runs_end_to_end():
    cfg = ot.OceanConfig(resolution=128, compute_normals=False)
    state = ocean_state_from_phillips(cfg, PhillipsConfig(seed=3))
    out = ot.make_step(cfg)(state, jnp.float32(4.0))
    d = np.asarray(out.displacement)
    assert d.shape == (128, 128, 3)
    assert np.all(np.isfinite(d))
    assert np.abs(d[..., 1]).max() > 1e-3  # nontrivial waves


def test_tma_depth_attenuation():
    """Finite depth turns JONSWAP into TMA: a huge-but-finite depth
    matches the deep-water branch, and a shallow sea concentrates
    (normalized) energy at higher k — the Kitaigorodskii factor plus the
    slower finite-depth dispersion strip the long-wave end."""
    from gfx_ocean_tpu.spectra.phillips import jonswap_spectrum

    n, L = 256, 4000.0
    deep = jonswap_spectrum(n, L, PhillipsConfig(model="jonswap"))
    near = jonswap_spectrum(n, L, PhillipsConfig(model="jonswap",
                                                 depth=1.0e9))
    np.testing.assert_allclose(near, deep, rtol=1e-9)
    shallow = jonswap_spectrum(n, L, PhillipsConfig(model="jonswap",
                                                    depth=5.0))
    assert np.all(np.isfinite(shallow)) and np.all(shallow >= 0)
    i = np.arange(n)
    kx = np.pi * (2 * i[None, :] - n - 1) / L
    ky = np.pi * (2 * i[:, None] - n - 1) / L
    k = np.hypot(kx, ky)
    cfg = PhillipsConfig(model="jonswap")
    wp = 22.0 * (cfg.gravity ** 2 / (cfg.wind_speed * cfg.fetch)) ** (1 / 3)
    kp = wp * wp / cfg.gravity
    low = k < 2 * kp
    frac_deep = deep[low].sum() / deep.sum()
    frac_shallow = shallow[low].sum() / shallow.sum()
    assert frac_shallow < frac_deep * 0.9


def test_jonswap_cascades():
    """Cascaded JONSWAP synthesis: each cascade normalizes against the
    Phillips envelope at ITS OWN domain, so all three produce live,
    finite, distinct fields."""
    cfg = ot.OceanConfig(resolution=64, num_cascades=3,
                         compute_normals=False)
    st = ocean_state_from_phillips(
        cfg, PhillipsConfig(model="jonswap", seed=5))
    out = ot.make_step(cfg)(st, jnp.float32(2.0))
    d = np.asarray(out.displacement)
    assert d.shape == (3, 64, 64, 3) and np.all(np.isfinite(d))
    for c in range(3):
        assert np.abs(d[c, ..., 1]).max() > 1e-6
    assert not np.allclose(d[0], d[1])


def test_cascades_vmap():
    """Config 4: 3 cascaded patches via vmap, plus foam."""
    cfg = ot.OceanConfig(resolution=128, num_cascades=3, compute_foam=True,
                         compute_normals=True)
    state = ocean_state_from_phillips(cfg, PhillipsConfig(seed=1))
    assert state.h0.shape == (3, 2, 128, 128)
    out = ot.make_step(cfg)(state, jnp.float32(2.0))
    assert out.displacement.shape == (3, 128, 128, 3)
    assert out.normals.shape == (3, 128, 128, 3)
    assert out.foam.shape == (3, 128, 128)
    # cascade domains form the geometric ladder L, L/4, L/16
    assert cfg.domains == (1000.0, 250.0, 62.5)
    # different domains -> different fields
    d = np.asarray(out.displacement)
    assert not np.allclose(d[0], d[1])


def test_cascade_batched_equals_individual():
    cfg = ot.OceanConfig(resolution=64, num_cascades=2, compute_normals=False)
    state = ocean_state_from_phillips(cfg, PhillipsConfig(seed=9))
    batched = ot.make_step(cfg)(state, jnp.float32(1.0))
    for c in range(2):
        single_cfg = ot.OceanConfig(resolution=64, compute_normals=False,
                                    domain_size=cfg.domains[c])
        single_state = ot.OceanState(h0=state.h0[c], omega=state.omega[c])
        single = ot.make_step(single_cfg)(single_state, jnp.float32(1.0))
        np.testing.assert_allclose(np.asarray(batched.displacement[c]),
                                   np.asarray(single.displacement),
                                   atol=2e-4, rtol=0)
