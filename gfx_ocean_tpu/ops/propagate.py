"""Spectrum time-evolution (JAX equivalent of ``shader/propagate.comp``).

The reference dispatches 512^2 SIMT threads (``src/render.rs:1123-1130``);
here the whole pass is a handful of vectorized VPU expressions that XLA
fuses into the downstream FFT matmuls — the three intermediate spectrum
buffers and the two pipeline barriers of the reference
(``src/render.rs:1132-1156``) do not exist.

Semantics (``shader/propagate.comp:42-71``), arrays indexed [y, x]:
    h(k,t)  = h0[y, x] * e^{i w t} + h0[N-1-y, N-1-x] * e^{-i w t}
              (conjugate on the negated sample only if ``compat.conj_neg`` —
               the reference omits it, canonical Tessendorf has it)
    k       = pi * (2*i - N - 1) / L per axis, where the reference's uint32
              wraparound (SURVEY.md Q1) is replicated iff ``compat.wrap_k``
    disp_x  = -i * k_hat_x * h ;  disp_z = -i * k_hat_y * h
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gfx_ocean_tpu.config import CompatFlags
from gfx_ocean_tpu.golden.reference import wavenumber_1d


@functools.lru_cache(maxsize=None)
def _khat_np(n: int, domain_size: float, wrap: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Precomputed normalized wavenumber grids (f64 on host, stored f32)."""
    kx = wavenumber_1d(n, domain_size, wrap)[None, :]
    ky = wavenumber_1d(n, domain_size, wrap)[:, None]
    k_len = np.sqrt(kx * kx + ky * ky)
    safe = k_len > 1.0e-10
    with np.errstate(invalid="ignore", divide="ignore"):
        kxn = np.where(safe, kx / k_len, 0.0)
        kyn = np.where(safe, ky / k_len, 0.0)
    return (
        np.broadcast_to(kxn, (n, n)).astype(np.float32),
        np.broadcast_to(kyn, (n, n)).astype(np.float32),
    )


def wavenumber_grid(n: int, domain_size: float, wrap: bool = False):
    """(k_hat_x, k_hat_y) as (N, N) float32 device constants."""
    kxn, kyn = _khat_np(n, float(domain_size), bool(wrap))
    return jnp.asarray(kxn), jnp.asarray(kyn)


def propagate(
    h0: jnp.ndarray,
    omega: jnp.ndarray,
    t: jnp.ndarray,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Evolve the initial spectrum to time ``t``.

    Args:
        h0:    complex64 (..., N, N) initial height spectrum h0(k).
        omega: float32 (..., N, N) dispersion w(k) in rad/s.
        t:     scalar time (traced — the only per-step input, matching the
               reference's stateless-in-time design, SURVEY.md §5).

    Returns:
        (h_spec, dx_spec, dz_spec), each complex64 (..., N, N).
    """
    n = h0.shape[-1]
    phase = omega * t
    e_pos = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))

    h0_neg = h0[..., ::-1, ::-1]
    if compat.conj_neg:
        h0_neg = jnp.conj(h0_neg)
    h = h0 * e_pos + h0_neg * jnp.conj(e_pos)

    kxn, kyn = wavenumber_grid(n, domain_size, compat.wrap_k)
    dx = -1j * kxn * h
    dz = -1j * kyn * h
    return h, dx, dz


def precompute_propagate(h0_pair: jnp.ndarray, compat: CompatFlags = CompatFlags()):
    """Time-invariant combination planes of the propagate pass.

    ``h = h0 e^{iwt} + h0n e^{-iwt}`` expands to hr = c*P1 + s*P2,
    hi = s*P3 + c*P4 with P1..P4 independent of t (P* mix h0 with its
    both-axes flip). Hoisting them out of a rollout's scan removes the
    per-step flip gathers and half the propagate reads — worth ~2 ms/step
    at 4096^2. Returns a (4, ..., N, N) stack (P1, P2, P3, P4).
    """
    h0r = h0_pair[..., 0, :, :]
    h0i = h0_pair[..., 1, :, :]
    h0nr = h0r[..., ::-1, ::-1]
    h0ni = h0i[..., ::-1, ::-1]
    if compat.conj_neg:
        h0ni = -h0ni
    return jnp.stack([h0r + h0nr, h0ni - h0i, h0r - h0nr, h0i + h0ni], axis=0)


# Cody-Waite constants: 2*pi = C1 + C2 + C3 with C1/C2 carrying <=12
# mantissa bits each, so k * C1 and k * C2 are EXACT f32 products for
# k < 2^12 (plain hi/lo two-term reduction still loses 2^-24 * |omega t|,
# which is the very error being removed).
_C1 = np.float32(6.28125)   # 12-bit head of 2*pi
_C2 = np.float32(0.0019350051879882812)   # 12-bit head of the remainder
_C3 = np.float32(3.019916050561733e-07)   # final residual


def _split_f32_12bit(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 mantissa bits
    (so hi*hi products of two such halves are exact in f32)."""
    c = a * jnp.float32(4097.0)  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _phase_mod_2pi(omega: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """omega * t reduced mod 2*pi with ~f64-grade accuracy in f32 ops.

    A plain f32 product loses ~|omega*t| * 2^-24 of phase — at t ~ 1000 s
    that is ~3e-4 rad, which dominates the field error budget (the GLSL
    reference has the same flaw; the golden model is f64). Dekker
    two-product recovers the product's residual, and a two-term 2*pi
    reduction keeps the result accurate for any practical t.
    """
    t = jnp.float32(t)
    p = omega * t
    # exact product residual via Dekker splitting (no f32 FMA in XLA ops)
    o_hi, o_lo = _split_f32_12bit(omega)
    t_hi, t_lo = _split_f32_12bit(jnp.broadcast_to(t, ()))
    err = (((o_hi * t_hi - p) + o_hi * t_lo) + o_lo * t_hi) + o_lo * t_lo
    k = jnp.round(p * jnp.float32(1.0 / (2.0 * np.pi)))
    return (((p - k * _C1) - k * _C2) - k * _C3) + err


def propagate_planes_pre(
    pre: jnp.ndarray,
    omega: jnp.ndarray,
    t: jnp.ndarray,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Propagate from :func:`precompute_propagate` planes (the hot path)."""
    phase = _phase_mod_2pi(omega, t)
    return propagate_from_cs(pre, jnp.cos(phase), jnp.sin(phase),
                             domain_size, compat)


def propagate_from_cs(
    pre: jnp.ndarray,
    c: jnp.ndarray,
    s: jnp.ndarray,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Propagate given (cos, sin) of the phase directly.

    Used by the phase-recurrence rollout (``make_uniform_rollout``): with a
    uniform dt, e^{iw(t+dt)} = e^{iwt} * e^{iw dt}, so (c, s) update by one
    complex multiply per frame instead of two transcendentals over the full
    grid — the dominant propagate cost at 4096^2.
    """
    n = pre.shape[-1]
    hr = c * pre[0] + s * pre[1]
    hi = s * pre[2] + c * pre[3]
    kxn, kyn = wavenumber_grid(n, domain_size, compat.wrap_k)
    specs_r = jnp.stack([hr, kxn * hi, kyn * hi], axis=0)
    specs_i = jnp.stack([hi, -kxn * hr, -kyn * hr], axis=0)
    return specs_r, specs_i


def roll_flip(x: jnp.ndarray) -> jnp.ndarray:
    """The DFT-index negation gather rho: y[i, j] = x[(-i) mod N, (-j) mod N]
    over the last two axes (reverse + roll-by-one; index 0 stays put).

    This is the flip under which the transform conjugates:
    F(conj(x o rho)) = conj(F(x)) — the identity behind Hermitian
    symmetrization. NOT the same as the propagate pairing flip
    ``[N-1-i]`` (``index_neg`` of shader/propagate.comp:48), which negates
    the *centered* wavenumber 2i-N-1 instead of the DFT index.
    """
    return jnp.roll(x[..., ::-1, ::-1], shift=(1, 1), axis=(-2, -1))


def precompute_propagate_packed(h0_pair: jnp.ndarray, omega: jnp.ndarray,
                                compat: CompatFlags = CompatFlags()):
    """Time-invariant planes for the Hermitian-symmetrized propagate.

    Field packing (``models/ocean.py`` ``hermitian_pack``) needs, besides
    the plain combination planes P1..P4, their rho-gathered twins Q1..Q4
    and the rho-gathered dispersion (omega o rho != omega: omega is
    symmetric under the *centered* flip [N-1-i], not under the DFT-index
    flip rho). All are gathered once per rollout, never in the scan body.

    Returns ``(pre, pre_rho, omega_rho)``.
    """
    pre = precompute_propagate(h0_pair, compat)
    return pre, roll_flip(pre), roll_flip(omega)


def propagate_packed_planes(
    pre: jnp.ndarray,
    pre_rho: jnp.ndarray,
    omega: jnp.ndarray,
    omega_rho: jnp.ndarray,
    t: jnp.ndarray,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Hermitian-symmetrized evolved spectra, packed for 2-for-1 transforms.

    The step needs only Re(F(S)) per spectrum (``shader/correction.comp:31``
    keeps the real component). With H = (S + conj(S o rho)) / 2 the identity
    F(conj(S o rho)) = conj(F(S)) gives F(H) = Re(F(S)) EXACTLY — a
    Hermitian input whose transform is real. Two such spectra then share
    ONE complex transform: F(H_dx + i*H_dz) = dx_field + i*dz_field. That
    cuts the per-frame transform work from 18 to 14 real matmul-stages
    (the height field rides alone, keeping the ``choppy_precision`` split
    available for the packed choppy pair).

    conj(S o rho) evolves with the rho-gathered tables: S_rho_r/i are the
    same elementwise combinations as S built from (Q1..Q4, cos/sin of
    omega_rho * t), so the scan body stays gather-free.

    Returns ``(h_r, h_i, z_r, z_i)``: the symmetrized height spectrum (its
    transform is the real height field) and the packed Z = H_dx + i*H_dz.
    """
    n = pre.shape[-1]
    phase = _phase_mod_2pi(omega, t)
    c, s = jnp.cos(phase), jnp.sin(phase)
    phase_rho = _phase_mod_2pi(omega_rho, t)
    cq, sq = jnp.cos(phase_rho), jnp.sin(phase_rho)

    sr = c * pre[0] + s * pre[1]       # S = evolved height spectrum
    si = s * pre[2] + c * pre[3]
    tr = cq * pre_rho[0] + sq * pre_rho[1]   # S o rho
    ti = sq * pre_rho[2] + cq * pre_rho[3]

    half = jnp.float32(0.5)
    h_r = half * (sr + tr)
    h_i = half * (si - ti)

    kxn, kyn = wavenumber_grid(n, domain_size, compat.wrap_k)
    # rho-gathered grids derived IN-GRAPH from the same host tables: baking
    # them as separate literals doubles the program's constant payload
    # (134 MB at 4096^2); a reverse+roll of the existing constant is free
    # to ship and fuses into the elementwise consumers.
    kxq, kyq = roll_flip(kxn), roll_flip(kyn)
    # S_dx = -i k_hat_x S => planes (kx*si, -kx*sr); conj(S_dx o rho) =
    # (kxq*ti, +kxq*tr). Same for dz with k_hat_y.
    dx_r = half * (kxn * si + kxq * ti)
    dx_i = half * (kxq * tr - kxn * sr)
    dz_r = half * (kyn * si + kyq * ti)
    dz_i = half * (kyq * tr - kyn * sr)
    # Z = H_dx + i * H_dz
    z_r = dx_r - dz_i
    z_i = dx_i + dz_r
    return h_r, h_i, z_r, z_i


def propagate_planes(
    h0_pair: jnp.ndarray,
    omega: jnp.ndarray,
    t: jnp.ndarray,
    domain_size: float,
    compat: CompatFlags = CompatFlags(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All-real-plane variant of :func:`propagate` — the hot path.

    Complex dtype never appears (``utils/complexpair.py``).
    Expanding ``h = h0 e^{iwt} + h0n e^{-iwt}`` with c = cos(wt), s = sin(wt)
    and (r, i) planes:

        hr = c (h0r + h0nr) + s (h0ni - h0i)
        hi = s (h0r - h0nr) + c (h0i + h0ni)
        dx = -i khx h  =>  dxr =  khx hi, dxi = -khx hr   (and same for dz)

    Args:
        h0_pair: float32 (..., 2, N, N) — (re, im) planes of h0.
    Returns:
        (specs_r, specs_i): each float32 (3, ..., N, N), order (h, dx, dz) —
        matching the stacking the 2-D transform consumes.
    """
    pre = precompute_propagate(h0_pair, compat)
    return propagate_planes_pre(pre, omega, t, domain_size, compat)
