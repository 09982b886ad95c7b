"""Asset loading: bincode format, shipped-bin statistics, round-trip."""

import struct

import numpy as np
import pytest

from gfx_ocean_tpu.assets import bincode


def test_spectrum_shape_and_range(reference_state, shipped_assets):
    h0, omega = reference_state
    assert h0.shape == (512, 512) and h0.dtype == np.complex64
    assert omega.shape == (512, 512) and omega.dtype == np.float32
    # Ranges verified by direct parse in SURVEY.md §2.2.
    re, im = np.real(h0), np.imag(h0)
    lo, hi = min(re.min(), im.min()), max(re.max(), im.max())
    assert -0.99 < lo < -0.9
    assert 0.7 < hi < 0.8
    assert 0.13 < omega.min() < 0.14
    assert 4.7 < omega.max() < 4.8


def test_omega_consistent_with_deep_water_dispersion(reference_state):
    """omega.bin (shipped, or generated by conftest) should be
    sqrt(g |k|) on the centered wavenumber grid (SURVEY.md §3.4) — also
    validates our k-grid conventions."""
    _, omega = reference_state
    from gfx_ocean_tpu.golden.reference import wavenumber_1d

    kx = wavenumber_1d(512, 1000.0, wrap=False)[None, :]
    ky = wavenumber_1d(512, 1000.0, wrap=False)[:, None]
    k = np.sqrt(kx * kx + ky * ky)
    expected = np.sqrt(9.81 * k)
    err = np.abs(expected - omega.astype(np.float64))
    assert np.median(err) < 1e-4, f"median dispersion mismatch {np.median(err)}"


def test_bincode_roundtrip(tmp_path, rng):
    h0 = (rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))).astype(np.complex64)
    om = rng.standard_normal((16, 16)).astype(np.float32)
    sp, op = str(tmp_path / "s.bin"), str(tmp_path / "o.bin")
    bincode.save_spectrum(sp, h0)
    bincode.save_omega(op, om)
    assert np.array_equal(bincode.load_spectrum(sp, 16), h0)
    assert np.array_equal(bincode.load_omega(op, 16), om)


def test_bincode_rejects_bad_length():
    buf = struct.pack("<Q", 10) + b"\x00" * 8
    with pytest.raises(ValueError):
        bincode.parse_bincode_f32(buf)
    with pytest.raises(ValueError):
        bincode.parse_bincode_vec2f(buf)
