"""FFT implementations vs numpy: matmul (direct + four-step) and xla paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gfx_ocean_tpu.ops.fft import ifft1d_unnorm, ifft2_unnorm


def _rand_complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("impl", ["matmul", "xla"])
@pytest.mark.parametrize("n", [16, 64, 512])
def test_ifft1d_matches_numpy(rng, impl, n):
    x = _rand_complex(rng, (4, n))
    got = np.asarray(ifft1d_unnorm(jnp.asarray(x), impl=impl))
    want = np.fft.ifft(x.astype(np.complex128), axis=-1) * n
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5


@pytest.mark.parametrize("n", [256, 2048, 4096])
def test_ifft1d_foursteps_matches_numpy(rng, n):
    """Force the four-step path by lowering direct_max below n."""
    x = _rand_complex(rng, (2, n))
    got = np.asarray(ifft1d_unnorm(jnp.asarray(x), impl="matmul", direct_max=128))
    want = np.fft.ifft(x.astype(np.complex128), axis=-1) * n
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-5


@pytest.mark.parametrize("impl", ["matmul", "xla"])
@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (3, 128, 128)])
def test_ifft2_matches_numpy(rng, impl, shape):
    x = _rand_complex(rng, shape)
    got = np.asarray(ifft2_unnorm(jnp.asarray(x), impl=impl))
    want = np.fft.ifft2(x.astype(np.complex128)) * (shape[-1] * shape[-2])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5


def test_ifft2_foursteps_path(rng):
    x = _rand_complex(rng, (512, 512))
    got = np.asarray(ifft2_unnorm(jnp.asarray(x), impl="matmul", direct_max=64))
    want = np.fft.ifft2(x.astype(np.complex128)) * 512 * 512
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-5


def test_fft_ifft_identity(rng):
    """Property: forward(ifft_unnorm(x)) == N * x (Q3 scaling)."""
    n = 128
    x = _rand_complex(rng, (n,))
    y = np.asarray(ifft1d_unnorm(jnp.asarray(x)[None], impl="matmul"))[0]
    roundtrip = np.fft.fft(y)
    assert np.abs(roundtrip - n * x).max() / np.abs(x).max() / n < 1e-5


def test_axis_argument(rng):
    x = _rand_complex(rng, (32, 8))
    got = np.asarray(ifft1d_unnorm(jnp.asarray(x), axis=0, impl="matmul"))
    want = np.fft.ifft(x.astype(np.complex128), axis=0) * 32
    assert np.abs(got - want).max() < 1e-4


def test_jit_and_grad_safe(rng):
    """ifft2_unnorm must be traceable under jit (static shapes only)."""
    x = jnp.asarray(_rand_complex(rng, (64, 64)))
    f = jax.jit(lambda a: jnp.sum(jnp.abs(ifft2_unnorm(a)) ** 2))
    assert np.isfinite(float(f(x)))


@pytest.mark.parametrize("prec", ["bf16x3", "bf16x4", "high", "highest"])
def test_precision_tiers_accuracy(rng, prec):
    """All compliant tiers must stay inside the 1e-4 budget (on CPU every
    tier runs exact f32 products, so this mainly guards plumbing; the
    GPU numbers come from chip_smoke.py)."""
    x = _rand_complex(rng, (64, 64))
    got = np.asarray(ifft2_unnorm(jnp.asarray(x), impl="matmul", precision=prec))
    want = np.fft.ifft2(x.astype(np.complex128)) * 64 * 64
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_bf16_split_roundtrip(rng):
    """hi + lo must reconstruct the input exactly; hi must be
    bf16-representable (guards the bit-twiddling rounding)."""
    from gfx_ocean_tpu.ops.fft import _round_to_bf16_in_f32, _split_bf16

    a = jnp.asarray(rng.standard_normal((128, 128)).astype(np.float32))
    hi, lo = jax.jit(_split_bf16)(a)
    np.testing.assert_array_equal(np.asarray(hi) + np.asarray(lo), np.asarray(a))
    h = np.asarray(jax.jit(_round_to_bf16_in_f32)(a))
    # bf16-representable: f32 bit pattern has zero low 16 bits
    bits = h.view(np.uint32)
    assert np.all(bits & 0xFFFF == 0)
    # and it equals numpy's round-to-nearest-even bf16
    import ml_dtypes
    expect = np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(h, expect)


def test_unknown_precision_rejected(rng):
    x = _rand_complex(rng, (16, 16))
    with pytest.raises(ValueError, match="unknown matmul precision"):
        ifft2_unnorm(jnp.asarray(x), impl="matmul", precision="fp8")


def test_effective_precision_reports_remaps():
    """The tier that runs is reported as such: the explicit splits run as
    written on the matmul path (direct and four-step regime alike), and
    the xla FFT has no tier."""
    from gfx_ocean_tpu.ops.fft import effective_precision as ep

    for tier in ("bf16x3", "bf16x4", "high", "highest", "default"):
        assert ep(tier) == tier
    assert ep("bf16x3", impl="xla").startswith("n/a")
    with pytest.raises(ValueError):
        ep("f64")
