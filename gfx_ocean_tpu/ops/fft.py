"""Unnormalized inverse FFT, two implementations.

The reference does its 2-D inverse FFT as 512 independent shared-memory
radix-2 Stockham workgroups per axis (``shader/fft_row.comp``,
``shader/fft_col.comp``; dispatch at ``src/render.rs:1158-1231``) with no
1/N normalization (SURVEY.md §2.4 Q3). We verified the kernel computes
exactly ``y[n] = sum_k x[k] e^{+2 pi i n k / N}`` = ``N * ifft(x)``.

* ``matmul`` (default): a DFT is a dense linear map, so a full 2-D
  transform is ``W @ X @ W`` (W symmetric), i.e. two complex matmuls = 8
  real matmuls, zero shuffles, zero barriers. For large N
  (> ``direct_max``) a four-step Cooley-Tukey split N = N1*N2 reduces the
  work from O(N^2) to O(N*(N1+N2)) per line while *staying batched
  matmuls*: small-DFT (matmul) -> twiddle (elementwise, fused by XLA) ->
  small-DFT (matmul). This is the same row/col + staging decomposition as
  the reference's shared-memory kernel, re-expressed as matmuls.

* ``xla``: ``jnp.fft.ifftn`` scaled by N — XLA's FFT op (cuFFT on the
  GPU).

The hot path works on (re, im) float32 plane pairs — complex dtype never
crosses the jit boundary (``utils/complexpair.py``). The complex-typed
public wrappers exist for tests and external callers.

Precision tiers (``config.OceanConfig.matmul_precision``): XLA-native
"highest" / "high" / "default", plus the explicit-split "bf16x3" /
"bf16x4" (the default) — hi/lo operand decomposition done with integer
bit ops and barrier-pinned partial sums (see
_round_to_bf16_in_f32/_sum_split_dots for the two XLA simplifier traps
this has to dodge). Twiddle/DFT matrices are built in float64 on host
(phase computed mod N in integers, so they are exact even at
N = 4096^2) and rounded once to float32.
"""

from __future__ import annotations

import functools
from typing import Literal, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Impl = Literal["matmul", "xla"]

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
    # Explicit-split multi-pass (see _split_bf16/_mm): the hi+lo operand
    # split is exact to 24 bits and only the lo*lo (x3) product is
    # dropped (x4 keeps it).
    "bf16x3": "bf16x3",
    "bf16x4": "bf16x4",
}


def resolve_precision(name: str):
    try:
        return _PRECISIONS[name]
    except KeyError:
        raise ValueError(f"unknown matmul precision {name!r}; options: {sorted(_PRECISIONS)}")


def effective_precision(precision: str, impl: str = "matmul") -> str:
    """The tier that actually executes: the requested tier on the matmul
    path at every N, none on the xla path (``jnp.fft`` — the tiers do not
    apply)."""
    resolve_precision(precision)  # validate
    if impl == "xla":
        return "n/a (XLA FFT kernel; precision tiers do not apply)"
    return precision


def _round_to_bf16_in_f32(a: jnp.ndarray) -> jnp.ndarray:
    """Round-to-nearest-even to bf16 precision, staying in float32, via
    integer bit manipulation.

    Why not ``a.astype(bf16)``: XLA may elide f32->bf16 converts that
    feed a dot ("excess precision" folding), so a convert-based hi/lo
    split collapses: every cross-term dot receives the ORIGINAL f32 value
    and the multi-pass scheme silently degrades to a single pass (the lo
    plane constant-folds to zero). Bit ops are opaque to the simplifier.
    """
    u = jax.lax.bitcast_convert_type(a, jnp.uint32)
    lsb = (u >> 16) & jnp.uint32(1)
    u = (u + jnp.uint32(0x7FFF) + lsb) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


def _split_bf16(a: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact two-term bf16 decomposition a ~= hi + lo, both carried as f32.

    ``hi`` is exactly bf16-representable, so the dot's internal bf16
    rounding is lossless on it; ``lo`` is the exact f32 residual, rounded
    to bf16 inside the dot (which is precisely the scheme's granularity).
    """
    hi = _round_to_bf16_in_f32(a)
    return hi, a - hi


def _sum_split_dots(d, a_hi, a_lo, b_hi, b_lo, four: bool) -> jnp.ndarray:
    """hi/lo cross-term sum with each product pinned behind a barrier.

    Without the barriers XLA's algebraic simplifier refactors
    ``d(a,b_hi) + d(a,b_lo) -> d(a, b_hi + b_lo)``, whose low-precision
    addition rounds lo away (the whole scheme silently collapses to a
    single pass).
    """
    terms = [d(a_hi, b_hi), d(a_hi, b_lo), d(a_lo, b_hi)]
    if four:
        terms.append(d(a_lo, b_lo))
    terms = [jax.lax.optimization_barrier(t) for t in terms]
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _split_dot(d, a: jnp.ndarray, b: jnp.ndarray, prec) -> jnp.ndarray:
    """``d(a, b)`` at tier ``prec``: the explicit-split tiers run as
    barrier-pinned partial products at DEFAULT precision."""
    if prec in ("bf16x3", "bf16x4"):
        a_hi, a_lo = _split_bf16(a)
        b_hi, b_lo = _split_bf16(b)
        return _sum_split_dots(
            functools.partial(d, precision=jax.lax.Precision.DEFAULT),
            a_hi, a_lo, b_hi, b_lo, prec == "bf16x4")
    return d(a, b, precision=prec)


def _mm(a: jnp.ndarray, b: jnp.ndarray, prec) -> jnp.ndarray:
    """Central matmul with the extended precision tiers."""
    return _split_dot(jnp.matmul, a, b, prec)


def _einsum(spec: str, a: jnp.ndarray, b: jnp.ndarray, prec) -> jnp.ndarray:
    """Einsum twin of :func:`_mm` (four-step stages, N > direct_max)."""
    return _split_dot(functools.partial(jnp.einsum, spec), a, b, prec)


# --------------------------------------------------------------------------
# Host-side constant tables (float64 -> float32, cached per (n, sign)).
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(real, imag) of W[j, k] = exp(sign * 2 pi i j k / n), float32 from f64.

    The phase exponent is reduced mod n in integer arithmetic before the f64
    multiply, so the twiddles carry no accumulation error at any n.
    """
    jk = np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)) % n
    theta = (2.0 * np.pi * sign / n) * jk.astype(np.float64)
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """Four-step twiddle T[a, b] = exp(sign * 2 pi i a b / (n1*n2)), (n1, n2)."""
    n = n1 * n2
    ab = np.outer(np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)) % n
    theta = (2.0 * np.pi * sign / n) * ab.astype(np.float64)
    return np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)


def _split(n: int) -> Tuple[int, int]:
    """Balanced N = N1 * N2 split with both factors powers of two.

    Balanced minimizes FLOPs (cost ~ N1 + N2 per element).
    """
    log = n.bit_length() - 1
    l1 = log // 2
    return 1 << l1, 1 << (log - l1)


def dft_matrices(n: int, sign: int = 1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    wr, wi = _dft_matrix_np(n, sign)
    return jnp.asarray(wr), jnp.asarray(wi)


# --- centering-sign folding -------------------------------------------------
#
# The correction pass multiplies the field by (-1)^(x+y) (with the
# reference's global flip, SURVEY.md Q2 / shader/correction.comp:29).
# (-1)^(x+y) factorizes per axis, and each factor is a diagonal that can be
# absorbed into the OUTPUT side of that axis' DFT matrix at table-build
# time — the whole correction pass then costs zero runtime ops.

@functools.lru_cache(maxsize=None)
def _alt_np(n: int) -> np.ndarray:
    """(-1)^i, float32, length n."""
    a = np.ones(n, dtype=np.float32)
    a[1::2] = -1.0
    return a


@functools.lru_cache(maxsize=None)
def _dft_matrix_out_alt_np(n: int, sign: int, axis: int,
                           negate: bool) -> Tuple[np.ndarray, np.ndarray]:
    """DFT matrix with (-1)^(output index) folded in.

    axis=1 folds into columns (for right-multiplication Y = X @ W, where the
    output index selects a column); axis=0 folds into rows (for Y = W @ X).
    ``negate`` additionally flips the global sign (the reference's Q2 flip).
    """
    wr, wi = _dft_matrix_np(n, sign)
    alt = _alt_np(n) * (np.float32(-1.0) if negate else np.float32(1.0))
    if axis == 1:
        return wr * alt[None, :], wi * alt[None, :]
    return wr * alt[:, None], wi * alt[:, None]


# --------------------------------------------------------------------------
# Plane-pair kernels (the hot path; no complex dtype anywhere).
# --------------------------------------------------------------------------

def _direct_last(xr, xi, prec, real_out: bool, out_alt: bool = False,
                 negate: bool = False):
    """Dense DFT along the last axis: Y = X @ W (W symmetric).

    real_out skips the imaginary output plane: 2 matmuls instead of 4.
    out_alt folds (-1)^(output index) into W (centering sign, free);
    negate further flips the global sign.
    """
    n = xr.shape[-1]
    if out_alt:
        wr, wi = (jnp.asarray(a) for a in _dft_matrix_out_alt_np(n, 1, 1, negate))
    else:
        wr, wi = dft_matrices(n, sign=1)
    yr = _mm(xr, wr, prec) - _mm(xi, wi, prec)
    if real_out:
        return yr, None
    yi = _mm(xr, wi, prec) + _mm(xi, wr, prec)
    return yr, yi


def _foursteps_last(xr, xi, prec, real_out: bool, out_alt: bool = False,
                    negate: bool = False):
    """Four-step split along the last axis: O(N*(N1+N2)) as batched matmuls.

    Derivation (sign +1, unnormalized): with k = N2*k1 + k2, n = n1 + N1*n2,
      y[n1 + N1 n2] = sum_{k2} W_N[n1 k2] * (sum_{k1} X[k1,k2] W_{N1}[n1 k1])
                      * W_{N2}[n2 k2]
    i.e. reshape -> small DFT over k1 (matmul) -> twiddle (elementwise,
    fused by XLA) -> small DFT over k2 (matmul) -> transpose-reshape.
    real_out keeps only the real plane of the final stage. out_alt folds
    (-1)^(output index) into the tables: the output index is n1 + N1*n2
    with N1 even, so (-1)^n = (-1)^(n1) — a row scaling of W1.
    """
    n = xr.shape[-1]
    n1, n2 = _split(n)
    batch = xr.shape[:-1]
    xr = xr.reshape(batch + (n1, n2))  # X[k1, k2], row-major: k = N2*k1 + k2
    xi = xi.reshape(batch + (n1, n2))

    if out_alt:
        w1r, w1i = (jnp.asarray(a) for a in _dft_matrix_out_alt_np(n1, 1, 0, negate))
    else:
        w1r, w1i = (jnp.asarray(a) for a in _dft_matrix_np(n1, 1))
    w2r, w2i = (jnp.asarray(a) for a in _dft_matrix_np(n2, 1))
    tr, ti = (jnp.asarray(a) for a in _twiddle_np(n1, n2, 1))

    def lmm(w, x):  # A = W @ X over the n1 axis
        return _einsum("nk,...kj->...nj", w, x, prec)

    ar = lmm(w1r, xr) - lmm(w1i, xi)
    ai = lmm(w1r, xi) + lmm(w1i, xr)
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr

    def rmm(x, w):  # Y = B @ W^T over the n2 axis
        return _einsum("...nk,mk->...nm", x, w, prec)

    yr = rmm(br, w2r) - rmm(bi, w2i)
    # y_flat[n1 + N1*n2] = Y[n1, n2] -> swap to (n2, n1) then flatten.
    out_r = jnp.swapaxes(yr, -1, -2).reshape(batch + (n,))
    if real_out:
        return out_r, None
    yi = rmm(br, w2i) + rmm(bi, w2r)
    return out_r, jnp.swapaxes(yi, -1, -2).reshape(batch + (n,))


def _ifft_last_planes(xr, xi, prec, direct_max: int, real_out: bool):
    n = xr.shape[-1]
    if n <= direct_max:
        return _direct_last(xr, xi, prec, real_out)
    return _foursteps_last(xr, xi, prec, real_out)


def ifft1d_real_unnorm(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    axis: int = -1,
    direct_max: int = 1024,
    precision: str = "highest",
) -> jnp.ndarray:
    """Re(unnormalized inverse DFT) along ``axis``, plane-pair inputs."""
    prec = resolve_precision(precision)
    if axis not in (-1, xr.ndim - 1):
        xr = jnp.moveaxis(xr, axis, -1)
        xi = jnp.moveaxis(xi, axis, -1)
        y, _ = _ifft_last_planes(xr, xi, prec, direct_max, real_out=True)
        return jnp.moveaxis(y, -1, axis)
    y, _ = _ifft_last_planes(xr, xi, prec, direct_max, real_out=True)
    return y


# --------------------------------------------------------------------------
# Public complex-typed wrappers (tests / external callers / golden paths).
# --------------------------------------------------------------------------

def ifft1d_unnorm(x: jnp.ndarray, axis: int = -1, impl: Impl = "matmul",
                  direct_max: int = 1024, precision: str = "highest") -> jnp.ndarray:
    """Unnormalized inverse DFT (= N * ifft) along ``axis``."""
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(jnp.complex64)
    n = x.shape[axis]
    if impl == "xla":
        return jnp.fft.ifft(x, axis=axis) * n
    prec = resolve_precision(precision)
    if axis not in (-1, x.ndim - 1):
        y = ifft1d_unnorm(jnp.moveaxis(x, axis, -1), -1, impl, direct_max, precision)
        return jnp.moveaxis(y, -1, axis)
    yr, yi = _ifft_last_planes(jnp.real(x), jnp.imag(x), prec, direct_max, real_out=False)
    return jax.lax.complex(yr, yi)


def ifft2_unnorm(x: jnp.ndarray, impl: Impl = "matmul",
                 direct_max: int = 1024, precision: str = "highest") -> jnp.ndarray:
    """Unnormalized 2-D inverse DFT over the last two axes (= N*M * ifft2).

    Matches the reference's row-pass + col-pass composition
    (``src/render.rs:1158-1231``).
    """
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(jnp.complex64)
    m, n = x.shape[-2], x.shape[-1]
    if impl == "xla":
        return jnp.fft.ifftn(x, axes=(-2, -1)) * (m * n)
    y = ifft1d_unnorm(x, axis=-1, impl=impl, direct_max=direct_max, precision=precision)
    return ifft1d_unnorm(y, axis=-2, impl=impl, direct_max=direct_max, precision=precision)


def row_pass_complex(xr, xi, prec, direct_max: int, fold: bool):
    """Full-complex DFT along the (locally complete) last axis; the
    x-half of the centering sign optionally folded into the output
    table. SHARED by the single-chip transform and the distributed
    shard body (parallel/distributed_fft.py) — the fold convention must
    never fork between them (CLAUDE.md: the sign is folded into tables,
    never applied twice)."""
    n = xr.shape[-1]
    if n <= direct_max:
        return _direct_last(xr, xi, prec, real_out=False, out_alt=fold)
    return _foursteps_last(xr, xi, prec, real_out=False, out_alt=fold)


def col_pass_real(ar, ai, prec, direct_max: int, fold: bool, negate: bool):
    """Real-output DFT along axis -2; folds the y-half of the centering
    sign (and the reference's global Q2 flip, ``negate``). Shared like
    ``row_pass_complex``. Direct regime multiplies from the left (no
    transpose); the four-step regime swaps into the last axis and back."""
    m = ar.shape[-2]
    if m <= direct_max:
        if fold:
            wr, wi = (jnp.asarray(a) for a in
                      _dft_matrix_out_alt_np(m, 1, 0, negate))
        else:
            wr, wi = dft_matrices(m, sign=1)
        return _mm(wr, ar, prec) - _mm(wi, ai, prec)
    ar = jnp.swapaxes(ar, -1, -2)
    ai = jnp.swapaxes(ai, -1, -2)
    y, _ = _foursteps_last(ar, ai, prec, real_out=True, out_alt=fold,
                           negate=negate)
    return jnp.swapaxes(y, -1, -2)


def col_pass_complex(ar, ai, prec, direct_max: int, fold: bool, negate: bool):
    """Complex-output DFT along axis -2 — the packed-transform twin of
    :func:`col_pass_real` (both planes kept: under Hermitian field packing
    Re/Im of the final transform ARE the two packed fields). Shared by the
    single-chip packed transform (:func:`ifft2_planes_unnorm`) and the
    distributed shard body (``parallel/distributed_fft.py``) — same
    folding convention, never forked."""
    m = ar.shape[-2]
    if m <= direct_max:
        if fold:
            wr, wi = (jnp.asarray(a) for a in
                      _dft_matrix_out_alt_np(m, 1, 0, negate))
        else:
            wr, wi = dft_matrices(m, sign=1)
        yr = _mm(wr, ar, prec) - _mm(wi, ai, prec)
        yi = _mm(wr, ai, prec) + _mm(wi, ar, prec)
        return yr, yi
    ar = jnp.swapaxes(ar, -1, -2)
    ai = jnp.swapaxes(ai, -1, -2)
    yr, yi = _foursteps_last(ar, ai, prec, real_out=False, out_alt=fold,
                             negate=negate)
    return jnp.swapaxes(yr, -1, -2), jnp.swapaxes(yi, -1, -2)


def ifft2_real_unnorm(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    impl: Impl = "matmul",
    direct_max: int = 1024,
    precision: str = "highest",
    centered: str | None = None,
) -> jnp.ndarray:
    """Real part of the unnormalized 2-D inverse DFT, from (re, im) planes.

    This is the hot path of ``step()``: the correction pass keeps only the
    real component (``shader/correction.comp:31``), so the column pass needs
    just Re(W @ A) — 6 real matmuls per field instead of 8 at direct
    sizes, and a real-only final stage in the four-step regime.

    Args:
        xr, xi: float32 (..., N, N) spectrum planes (complex never crosses
            the jit boundary — ``utils/complexpair.py``).
        centered: None for the plain transform; "ref" / "canonical" applies
            the (-1)^(x+y) centering fix-up of ``shader/correction.comp:29``
            (reference or canonical sign convention) for free by folding it
            into the DFT tables — the whole correction pass vanishes.
    """
    prec = resolve_precision(precision)
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    fold = centered is not None
    negate = centered == "ref"  # Q2: the reference's extra global flip
    if impl == "xla":
        m, n = xr.shape[-2], xr.shape[-1]
        out = jnp.real(jnp.fft.ifftn(jax.lax.complex(xr, xi), axes=(-2, -1))) * (m * n)
        if fold:
            from gfx_ocean_tpu.ops.derived import correction_sign  # noqa: PLC0415

            out = out * correction_sign(n, ref_sign=negate)
        return out
    # Row pass (x-half of the fold) then real-out column pass (y-half +
    # Q2 flip) — the shared per-axis passes, see their docstrings.
    ar, ai = row_pass_complex(xr, xi, prec, direct_max, fold)
    return col_pass_real(ar, ai, prec, direct_max, fold, negate)


def ifft2_planes_unnorm(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    impl: Impl = "matmul",
    direct_max: int = 1024,
    precision: str = "highest",
    centered: str | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Both planes of the unnormalized 2-D inverse DFT, from (re, im) planes.

    The complex-output twin of :func:`ifft2_real_unnorm` (same folding
    options). This is the transform under field packing (``models/ocean.py``
    ``hermitian_pack``): two Hermitian-symmetrized spectra ride one complex
    transform — Z = H1 + i*H2 has F(Z) = field1 + i*field2 with both planes
    exactly the real fields — so one (yr, yi) pair carries two outputs.
    """
    prec = resolve_precision(precision)
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    fold = centered is not None
    negate = centered == "ref"
    if impl == "xla":
        m, n = xr.shape[-2], xr.shape[-1]
        y = jnp.fft.ifftn(jax.lax.complex(xr, xi), axes=(-2, -1)) * (m * n)
        yr, yi = jnp.real(y), jnp.imag(y)
        if fold:
            from gfx_ocean_tpu.ops.derived import correction_sign  # noqa: PLC0415

            sign = correction_sign(n, ref_sign=negate)
            yr, yi = yr * sign, yi * sign
        return yr, yi
    ar, ai = row_pass_complex(xr, xi, prec, direct_max, fold)
    return col_pass_complex(ar, ai, prec, direct_max, fold, negate)
