"""CPU (numpy, float64) golden model of the reference pipeline.

Implements, bit-faithfully up to float precision, the exact semantics of the
reference's four compute passes (SURVEY.md §2.2/§2.4):

1. propagate (``shader/propagate.comp``):
     h(k, t)    = h0[idx] * e^{i w t} + h0[idx_neg] * e^{-i w t}
                  (NO conjugate on h0[idx_neg] — reference quirk; canonical
                  Tessendorf conjugates, selectable via ``conj_neg``)
     idx_neg    = flip of both axes: h0[N-1-y, N-1-x]  (``propagate.comp:48``)
     k          = pi * (2*i - N - 1) / L per axis      (``propagate.comp:45-52``)
                  with optional uint32 wraparound replication (Q1)
     disp_{x,z} = complex_mul((0, -k_hat), h) = -i * k_hat * h
                  (``propagate.comp:64-71``)
2. 2-D inverse FFT, UNNORMALIZED (``shader/fft_row.comp`` + ``fft_col.comp``):
     the Stockham radix-2 kernel with twiddle e^{+i pi k / bs} computes the
     plain inverse DFT sum  y[n] = sum_k x[k] e^{+2 pi i n k / N}  with no
     1/N factor (Q3), i.e. N^2 * numpy.fft.ifft2.
3. correction (``shader/correction.comp``):
     sign = -1 where (x+y) even, +1 where odd (Q2; canonical is +1 even),
     field = Re(F) * sign, packed as (disp_x, height, disp_z).
4. normals (``shader/ocean.frag:50-67``): central finite differences of the
   *raw* height channel with height_scale=180 and diff = 2/N.

All arithmetic runs in float64 so this model is strictly more accurate than
both the GLSL original and the JAX path; comparisons quantify the JAX path's
true error.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gfx_ocean_tpu.config import CompatFlags, OceanConfig


def wavenumber_1d(n: int, domain_size: float, wrap: bool) -> np.ndarray:
    """Centered wavenumber coordinate pi*(2i - N - 1)/L for i in [0, N).

    ``wrap=True`` replicates Q1: the reference evaluates ``2*i - N - 1`` in
    uint32 arithmetic (``shader/propagate.comp:45-46``), so any negative
    intended value wraps mod 2**32 and is then converted to float32.
    """
    i = np.arange(n, dtype=np.int64)
    signed = 2 * i - n - 1
    if wrap:
        wrapped = np.asarray(signed % (1 << 32), dtype=np.uint64)
        coord = wrapped.astype(np.float32).astype(np.float64)
    else:
        coord = signed.astype(np.float64)
    return np.pi * coord / float(domain_size)


def golden_propagate(
    h0: np.ndarray,
    omega: np.ndarray,
    t: float,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spectrum time evolution. Returns (h_spec, dx_spec, dz_spec), complex128.

    Arrays are indexed [y, x] (flat index = x + N*y, ``propagate.comp:42``).
    """
    n = h0.shape[0]
    h0 = np.asarray(h0, dtype=np.complex128)
    omega = np.asarray(omega, dtype=np.float64)

    phase = omega * float(t)
    e_pos = np.cos(phase) + 1j * np.sin(phase)
    e_neg = np.conj(e_pos)

    h0_neg = h0[::-1, ::-1]
    if compat.conj_neg:
        h0_neg = np.conj(h0_neg)
    h = h0 * e_pos + h0_neg * e_neg

    kx = wavenumber_1d(n, domain_size, compat.wrap_k)[None, :]  # varies along x (axis 1)
    ky = wavenumber_1d(n, domain_size, compat.wrap_k)[:, None]  # varies along y (axis 0)
    k_len = np.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-10
    with np.errstate(invalid="ignore", divide="ignore"):
        kxn = np.where(safe, kx / k_len, 0.0)
        kyn = np.where(safe, ky / k_len, 0.0)

    # complex_mul((0, -k_hat), h) == -i * k_hat * h  (propagate.comp:64-71)
    dx = -1j * kxn * h
    dz = -1j * kyn * h
    return h, dx, dz


def ifft2_unnorm_np(spec: np.ndarray) -> np.ndarray:
    """Unnormalized 2-D inverse DFT: N*N * ifft2 (Q3 — reference kernels
    carry no 1/N factor, ``shader/fft_row.comp:25-40``)."""
    n0, n1 = spec.shape[-2:]
    return np.fft.ifft2(spec) * (n0 * n1)


def correction_sign(n: int, ref_sign: bool) -> np.ndarray:
    """(y, x) sign grid of ``shader/correction.comp:29``.

    Reference: -1 where (x+y) even, +1 where odd (Q2).
    Canonical (ref_sign=False): +1 where even.
    """
    x = np.arange(n)[None, :]
    y = np.arange(n)[:, None]
    even = (x + y) % 2 == 0
    if ref_sign:
        return np.where(even, -1.0, 1.0)
    return np.where(even, 1.0, -1.0)


def golden_fields(
    h0: np.ndarray,
    omega: np.ndarray,
    t: float,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> np.ndarray:
    """Full propagate -> iFFT2 -> correction. Returns (N, N, 3) float64
    displacement map (disp_x, height, disp_z) — the rgba32f texture contents
    of ``shader/correction.comp:31-34`` (alpha dropped)."""
    n = h0.shape[0]
    h, dx, dz = golden_propagate(h0, omega, t, domain_size, compat)
    sign = correction_sign(n, compat.ref_sign)
    fx = np.real(ifft2_unnorm_np(dx)) * sign
    fy = np.real(ifft2_unnorm_np(h)) * sign
    fz = np.real(ifft2_unnorm_np(dz)) * sign
    return np.stack([fx, fy, fz], axis=-1)


def golden_normals(height: np.ndarray, height_scale: float = 180.0) -> np.ndarray:
    """Finite-difference normals of ``shader/ocean.frag:50-67``.

    ``textureOffset(.., ivec2(+-1, 0))`` steps one texel along texture x
    (our axis 1); ``ivec2(0, +-1)`` along texture y (axis 0). With repeat
    wrap (sampler Tile, ``src/render.rs:397-398``) offsets wrap around.
    na = normalize(-dx, (x1-x0)/hs, 0); nb = normalize(0, (z1-z0)/hs, dy);
    N = normalize(cross(na, nb)).
    """
    n0, n1 = height.shape
    diff_x = 2.0 / n1
    diff_y = 2.0 / n0
    x0 = np.roll(height, 1, axis=1)
    x1 = np.roll(height, -1, axis=1)
    z0 = np.roll(height, 1, axis=0)
    z1 = np.roll(height, -1, axis=0)

    def _norm(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    na = _norm(np.stack([np.full_like(height, -diff_x), (x1 - x0) / height_scale,
                         np.zeros_like(height)], axis=-1))
    nb = _norm(np.stack([np.zeros_like(height), (z1 - z0) / height_scale,
                         np.full_like(height, diff_y)], axis=-1))
    return _norm(np.cross(na, nb))


def golden_step(
    h0: np.ndarray,
    omega: np.ndarray,
    t: float,
    config: OceanConfig,
) -> dict:
    """Golden equivalent of the framework's ``step()`` output pytree."""
    disp = golden_fields(h0, omega, t, config.domain_size, config.compat)
    out = {
        "displacement": disp,
        "height": disp[..., 1],
    }
    if config.compute_normals:
        out["normals"] = golden_normals(disp[..., 1], config.normal_height_scale)
    if config.compute_foam:
        out["foam"] = golden_foam(disp, config)
    return out


def golden_foam(disp: np.ndarray, config: OceanConfig) -> np.ndarray:
    """Jacobian-determinant whitecap mask (BASELINE.json config 4).

    J = (1 + lam*ddx/dx)(1 + lam*ddz/dz) - (lam*ddx/dz)(lam*ddz/dx);
    foam where J < threshold. Central differences with wrap, grid spacing
    = domain_size / N.
    """
    n = disp.shape[0]
    dx_spacing = config.domain_size / n
    lam = config.foam_lambda

    def ddx(f):  # d/dx — texture x = axis 1
        return (np.roll(f, -1, axis=1) - np.roll(f, 1, axis=1)) / (2 * dx_spacing)

    def ddz(f):  # d/dz — texture y = axis 0
        return (np.roll(f, -1, axis=0) - np.roll(f, 1, axis=0)) / (2 * dx_spacing)

    fx, fz = disp[..., 0], disp[..., 2]
    jxx = 1.0 + lam * ddx(fx)
    jzz = 1.0 + lam * ddz(fz)
    jxz = lam * ddz(fx)
    jzx = lam * ddx(fz)
    jac = jxx * jzz - jxz * jzx
    return (jac < config.foam_threshold).astype(np.float64)
